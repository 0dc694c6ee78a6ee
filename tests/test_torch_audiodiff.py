"""The port's audio oracles (``utils/audiodiff.py``) against the JAX
package's on the same numpy inputs: the silence detector, the
silence-and-speech comparison, energy and SNR in dB. The fixtures are
seeded speech-like signals with silent spans of 0.5-2 s at 8, 16 and
48 kHz, a recording of each (delayed, scaled, with noise in the pauses),
an int16-scaled case, an empty input and a zero reference."""
import pytest

pytest.importorskip("torch")

import numpy as np  # noqa: E402

from mediastreamer2_tpu.utils import audiodiff as jax_ad  # noqa: E402
from mediastreamer2_tpu_torch.utils import audiodiff as ad  # noqa: E402
from mediastreamer2_tpu_torch.utils.signals import make_speechlike  # noqa: E402

RATES = (8000, 16000, 48000)
# (seconds of speech, seconds of silence after it)
SPANS = ((1.0, 0.5), (0.8, 2.0), (0.6, 1.0), (0.7, 0.0))


def speech_with_pauses(rate, seed):
    parts = []
    for k, (talk, quiet) in enumerate(SPANS):
        parts.append(make_speechlike(int(talk * rate), rate, seed=seed + k))
        parts.append(np.zeros(int(quiet * rate), np.float32))
    return np.concatenate(parts).astype(np.float32)


def recording(ref, rate, seed, delay_ms=23, gain=0.6, noise=3e-4):
    """``ref`` delayed, scaled and with a noise floor (a call's capture)."""
    rng = np.random.default_rng(seed)
    d = delay_ms * rate // 1000
    rec = np.concatenate([np.zeros(d, np.float32), gain * ref])[:len(ref)]
    return (rec + noise * rng.standard_normal(len(ref))).astype(np.float32)


@pytest.fixture(scope="module", params=RATES, ids=[f"{r // 1000}k" for r in RATES])
def pair(request):
    rate = request.param
    ref = speech_with_pauses(rate, seed=rate // 1000)
    return rate, ref, recording(ref, rate, seed=rate)


def _cases():
    rate = 8000
    ref = speech_with_pauses(rate, seed=5)
    int16 = np.round(ref * 32767.0).astype(np.float32)          # int16-scaled
    return {"int16": int16, "empty": np.zeros(0, np.float32),
            "zero": np.zeros(4000, np.float32), "noise": np.random.default_rng(2)
            .standard_normal(3000).astype(np.float32) * 1e-3}


@pytest.mark.parametrize("rate", RATES, ids=[f"{r // 1000}k" for r in RATES])
def test_silence_mask_equals_jax(rate):
    ref = speech_with_pauses(rate, seed=rate // 1000)
    got = ad.silence_mask(ref)
    np.testing.assert_array_equal(got, jax_ad.silence_mask(ref))
    # the detector finds the pauses: most of each long silent span is masked
    start = 0
    for talk, quiet in SPANS:
        start += int(talk * rate)
        if quiet >= 1.0:
            span = got[start + rate // 10:start + int(quiet * rate) - rate // 10]
            assert span.mean() > 0.9, (talk, quiet, span.mean())
        start += int(quiet * rate)


@pytest.mark.parametrize("case", ["int16", "empty", "zero", "noise"])
def test_silence_mask_edge_cases_equal_jax(case):
    x = _cases()[case]
    got = ad.silence_mask(x)
    assert got.dtype == bool and got.shape == x.shape
    np.testing.assert_array_equal(got, jax_ad.silence_mask(x))
    if case == "int16":          # scaled back to +-1: the float signal's mask
        ref = speech_with_pauses(8000, seed=5)
        np.testing.assert_array_equal(got, ad.silence_mask(ref))
    if case == "zero":
        assert got.all()


def test_silence_mask_window_arguments_equal_jax():
    ref = speech_with_pauses(16000, seed=9)
    for kw in ({"threshold": 0.01}, {"half_window": 50, "smooth_half_window": 300}):
        np.testing.assert_array_equal(ad.silence_mask(ref, **kw), jax_ad.silence_mask(ref, **kw))


def test_energy_db_matches_jax(pair):
    rate, ref, rec = pair
    for x in (ref, rec, ref[:rate // 2], np.zeros(100, np.float32), np.zeros(0, np.float32)):
        assert ad.energy_db(x) == pytest.approx(jax_ad.energy_db(x), abs=1e-6)
    assert ad.energy_db(np.zeros(0)) == pytest.approx(-120.0)


@pytest.mark.parametrize("align", [True, False], ids=["aligned", "unaligned"])
def test_snr_db_matches_jax(pair, align):
    rate, ref, rec = pair
    got = ad.snr_db(ref, rec, align=align)
    want = jax_ad.snr_db(ref, rec, align=align)
    assert got == pytest.approx(want, abs=1e-6)
    if align:                    # the delay found: the noise floor alone is left
        assert got > 20.0, got
    else:
        assert got < 5.0, got


def test_snr_db_zero_reference_and_empty():
    rec = np.random.default_rng(1).standard_normal(800).astype(np.float32)
    for align in (True, False):
        assert ad.snr_db(np.zeros(800), rec, align=align) == -np.inf
        assert jax_ad.snr_db(np.zeros(800), rec, align=align) == -np.inf
        assert ad.snr_db(np.zeros(0), np.zeros(0), align=align) == -np.inf


def test_compare_silence_and_speech_matches_jax(pair):
    rate, ref, rec = pair
    sim, energy = ad.audio_compare_silence_and_speech(ref, rec, rate)
    jsim, jenergy = jax_ad.audio_compare_silence_and_speech(ref, rec, rate)
    assert sim == pytest.approx(jsim, abs=1e-6)
    assert energy == pytest.approx(jenergy, rel=1e-6)
    assert sim > 0.99                   # the speech, delayed and scaled
    assert 0 < energy < 1e-6 * len(ref)  # the noise floor in the pauses


def test_compare_silence_and_speech_sees_echo_in_pauses():
    """Noise put into the reference's pauses raises the silence energy and
    leaves the speech similarity; both packages read the same."""
    rate = 16000
    ref = speech_with_pauses(rate, seed=31)
    rec = recording(ref, rate, seed=32, delay_ms=0)
    loud = rec + 0.05 * np.where(ad.silence_mask(ref), 1.0, 0.0).astype(np.float32) \
        * np.random.default_rng(3).standard_normal(len(rec)).astype(np.float32)
    quiet_e = ad.audio_compare_silence_and_speech(ref, rec, rate)[1]
    sim, loud_e = ad.audio_compare_silence_and_speech(ref, loud, rate, align_window_ms=(0, 1000))
    jsim, jloud_e = jax_ad.audio_compare_silence_and_speech(ref, loud, rate,
                                                            align_window_ms=(0, 1000))
    assert loud_e > 100 * quiet_e
    assert sim == pytest.approx(jsim, abs=1e-6) and loud_e == pytest.approx(jloud_e, rel=1e-6)


@pytest.mark.parametrize("case", ["empty", "zero"])
def test_compare_silence_and_speech_degenerate_inputs(case):
    x = _cases()[case]
    rec = np.random.default_rng(4).standard_normal(len(x)).astype(np.float32) * 0.01
    got = ad.audio_compare_silence_and_speech(x, rec, 8000)
    want = jax_ad.audio_compare_silence_and_speech(x, rec, 8000)
    assert got[0] == pytest.approx(want[0], abs=1e-6)
    assert got[1] == pytest.approx(want[1], rel=1e-6)
