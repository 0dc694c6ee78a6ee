"""The port's host codecs (``ops/host_codecs.py``, ctypes) against the JAX
package's on the CPU: the ``*_available()`` probes agree; Opus, GSM and
Speex give equal encoded bytes and decoded samples (Opus in-band FEC and
``decode(None)`` concealment too, Speex concealment too); the encoder's
complexity policy reads the same environment override; a codec whose
library is missing raises ``RuntimeError`` naming it. A test that needs
libopus, libgsm or libspeex skips where the library is missing; the
probes' agreement runs everywhere."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)              # tiny shapes: one thread, as the other port tests

from mediastreamer2_tpu.ops import host_codecs as j_hc  # noqa: E402
from mediastreamer2_tpu_torch.ops import host_codecs as t_hc  # noqa: E402
from mediastreamer2_tpu_torch.utils.signals import make_speechlike  # noqa: E402

PROBES = ("opus_available", "speex_available", "gsm_available", "g729_available",
          "bv16_available")


def _need(probe):
    if not getattr(t_hc, probe)():
        pytest.skip(f"{probe.split('_')[0]} library missing")


def test_probes_agree():
    assert {p: getattr(t_hc, p)() for p in PROBES} == {p: getattr(j_hc, p)() for p in PROBES}


@pytest.mark.parametrize("env,cores,want", [("", 1, 0), ("", 2, 5), ("", 8, -1), ("3", 8, 3),
                                            ("42", 1, 10), ("-7", 2, -1)])
def test_default_opus_complexity_matches(monkeypatch, env, cores, want):
    monkeypatch.setenv("MS2TPU_OPUS_COMPLEXITY", env)
    monkeypatch.setattr("os.cpu_count", lambda: cores)
    assert t_hc._default_opus_complexity() == j_hc._default_opus_complexity() == want


def _speech(n, rate, seed):
    return make_speechlike(n, rate, seed=seed)


@pytest.mark.parametrize("rate,bitrate,complexity", [(48000, 32000, None), (16000, 16000, 0),
                                                     (8000, 12000, 10)])
def test_opus_bytes_and_samples_equal(rate, bitrate, complexity):
    """20 frames of 10 ms through both packages' encoders (equal payloads)
    and decoders; frame 7 decoded from frame 8's in-band FEC and frame 12
    concealed (``decode(None)``), both equal too."""
    _need("opus_available")
    F = rate // 100
    x = _speech(20 * F, rate, seed=rate // 1000)
    payloads, outs = [], []
    for hc in (j_hc, t_hc):
        enc = hc.OpusEncoder(rate=rate, bitrate=bitrate, fec=True, complexity=complexity)
        enc.set_packet_loss(20)
        enc.set_bitrate(bitrate + 4000)
        pay = [enc.encode(x[i * F:(i + 1) * F]) for i in range(20)]
        dec = hc.OpusDecoder(rate=rate)
        out = []
        for i, p in enumerate(pay):
            if i == 7:
                continue
            if i == 8:
                out.append(dec.decode(p, F, fec=True))
            out.append(dec.decode(None if i == 12 else p, F))
        payloads.append(pay)
        outs.append(out)
    assert payloads[1] == payloads[0]
    assert len(outs[1]) == len(outs[0]) == 20
    for got, want in zip(*outs[::-1]):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_gsm_bytes_and_samples_equal():
    _need("gsm_available")
    x = _speech(160 * 12, 8000, seed=3)
    got = []
    for hc in (j_hc, t_hc):
        c = hc.GsmCodec()
        pay = [c.encode(x[k:k + 320]) for k in range(0, len(x), 320)]   # 40 ms packets
        got.append((pay, [c.decode(p) for p in pay]))
    (jp, jd), (tp, td) = got
    assert tp == jp and all(len(p) == 66 for p in tp)
    for a, b in zip(td, jd):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rate", [8000, 16000])
def test_speex_bytes_and_samples_equal(rate):
    _need("speex_available")
    x = _speech(rate // 50 * 10, rate, seed=5)
    got = []
    for hc in (j_hc, t_hc):
        c = hc.SpeexCodec(rate=rate, quality=6)
        fs = c.frame_samples
        pay = [c.encode(x[k:k + 2 * fs]) for k in range(0, len(x), 2 * fs)]
        dec = [c.decode(p) for p in pay] + [c.decode(None)]
        got.append((fs, pay, dec))
    assert got[1][:2] == got[0][:2]
    for a, b in zip(got[1][2], got[0][2]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("cls,lib", [("OpusEncoder", "libopus"), ("OpusDecoder", "libopus"),
                                     ("SpeexCodec", "libspeex"), ("GsmCodec", "libgsm"),
                                     ("G729Codec", "libbcg729"), ("Bv16Codec", "libbv16")])
def test_missing_library_raises_naming_it(monkeypatch, cls, lib):
    for name in ("_opus", "_speex", "_gsm", "_bcg729", "_bv16"):
        monkeypatch.setattr(t_hc, name, None)
    with pytest.raises(RuntimeError, match=lib):
        getattr(t_hc, cls)()
