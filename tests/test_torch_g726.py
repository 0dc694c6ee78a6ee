"""The port's G.726 codec (``ops/g726.py``; the plain versions of its CUDA
kernels in ``ops/kernels.py``) against the JAX package on the CPU.

The arithmetic is float32 through log2 and exp2, so the two backends may
round differently. Measured on these fixtures: no code differs at any
rate, decoded PCM differs by at most 0.026 of an int16 step, and every
state leaf by at most 2e-6 of the leaf's largest magnitude. The bars:
codes equal (tolerance 0), PCM ``atol`` 0.05, state ``rtol`` 1e-5 of the
leaf's largest magnitude."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from mediastreamer2_tpu.ops import g726 as jg  # noqa: E402
from mediastreamer2_tpu_torch import Factory  # noqa: E402
from mediastreamer2_tpu_torch.ops import g726 as tg  # noqa: E402
from mediastreamer2_tpu_torch.ops import kernels  # noqa: E402
from mediastreamer2_tpu_torch.utils.convert import from_jax, to_numpy  # noqa: E402

RATES = [2, 3, 4, 5]
PCM_ATOL = 0.05            # of an int16 step, before any rounding
STATE_RTOL = 1e-5          # of the leaf's largest magnitude


def _speech(n=2400, seed=0, tone=440.0, level=1.0):
    """The fixture of the JAX package's test (tests/test_g726.py), with the
    tone and the level varied per leg."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 8000
    sig = 7000 * np.sin(2 * np.pi * tone * t) \
        + 2500 * np.sin(2 * np.pi * 1100 * t) \
        + np.convolve(rng.standard_normal(n), np.ones(6) / 6, "same") * 800
    return np.clip(sig * level, -32000, 32000).astype(np.int32)


def _legs(n):
    return np.stack([_speech(n, 0), _speech(n, 1, 300.0, 0.5), _speech(n, 2, 700.0, 0.1),
                     _speech(n, 3, 1500.0, 1.5)])


def _assert_state_close(jst, tst):
    assert set(jst) == set(tst) == set(kernels.G726_KEYS)
    for k in jst:
        want, got = np.asarray(jst[k]), tst[k].numpy()
        assert got.dtype == np.float32 and got.shape == want.shape, k
        np.testing.assert_allclose(got, want, rtol=0, err_msg=k,
                                   atol=STATE_RTOL * max(float(np.abs(want).max()), 1e-3))


def test_tables_and_fresh_state_equal_the_jax_package():
    for bits in RATES:
        T = tg.g726_tables(bits, "cpu")
        for k, v in jg._RATE_TABLES[bits].items():
            np.testing.assert_array_equal(T[k].numpy(), v.astype(np.float32))
    jst, tst = jg.g726_state(3), tg.g726_state(3)
    assert list(tst) == list(kernels.G726_KEYS) == list(jst)
    for k in jst:
        np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))
    assert sum(v[0].numel() for v in tst.values()) == 24


@pytest.mark.parametrize("bits", RATES)
def test_encoder_codes_equal_jax_and_decoder_close(bits):
    """4 legs x 2,400 samples: the encoder's codes equal the JAX package's;
    the decoder, fed those codes, within PCM_ATOL; both final states within
    STATE_RTOL."""
    pcm = _legs(2400)
    jc, jes = jg.g726_encode(jnp.asarray(pcm), jg.g726_state(4), bits)
    tc, tes = tg.g726_encode(torch.from_numpy(pcm), tg.g726_state(4), bits)
    jc = np.array(jc)
    assert tc.dtype == torch.int32
    np.testing.assert_array_equal(tc.numpy(), jc)
    _assert_state_close(jes, tes)
    jd, jds = jg.g726_decode(jnp.asarray(jc), jg.g726_state(4), bits)
    td, tds = tg.g726_decode(torch.from_numpy(jc), tg.g726_state(4), bits)
    assert td.dtype == torch.float32
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=PCM_ATOL)
    _assert_state_close(jds, tds)


@pytest.mark.parametrize("bits,min_snr", [(2, 15), (3, 20), (4, 30), (5, 35)])
def test_roundtrip_snr(bits, min_snr):
    """The JAX test's floors, on its fixture (one leg, 2,400 samples)."""
    pcm = _speech()[None]
    codes, _ = tg.g726_encode(torch.from_numpy(pcm), tg.g726_state(1), bits)
    dec, _ = tg.g726_decode(codes, tg.g726_state(1), bits)
    ref, dec = pcm[0].astype(np.float64), dec[0].numpy()
    e = ref[400:] - dec[400:]
    snr = 10 * np.log10((ref[400:] ** 2).mean() / max((e ** 2).mean(), 1e-9))
    assert snr > min_snr, f"{bits}-bit SNR {snr:.1f}"
    c = codes.numpy()
    assert c.min() >= 0 and c.max() < (1 << bits)
    assert c.max() >= (1 << bits) - 2          # full range exercised


@pytest.mark.parametrize("bits", RATES)
def test_tickwise_equals_oneshot(bits):
    """Ten 80-sample ticks equal one shot, codes, samples and state (the
    state carries exactly; updated in place)."""
    pcm = _legs(800)[:2]
    one, st1 = kernels.g726_encode_reference(torch.from_numpy(pcm), tg.g726_state(2), bits)
    dec1, ds1 = kernels.g726_decode_reference(one, tg.g726_state(2), bits)
    st, ds = tg.g726_state(2), tg.g726_state(2)
    keep = st["b"]
    parts, dparts = [], []
    for k in range(10):
        c, st2 = tg.g726_encode(torch.from_numpy(pcm[:, k * 80:(k + 1) * 80].copy()), st, bits)
        assert st2 is st and st["b"] is keep
        parts.append(c)
        dparts.append(tg.g726_decode(c, ds, bits)[0])
    assert torch.equal(torch.cat(parts, dim=1), one)
    assert torch.equal(torch.cat(dparts, dim=1), dec1)
    for k in kernels.G726_KEYS:
        assert torch.equal(st[k], st1[k]) and torch.equal(ds[k], ds1[k]), k


@pytest.mark.parametrize("tick", [1, 7])
def test_short_ticks_equal_oneshot(tick):
    """Ticks of 1 and 7 samples (shorter than the kernels' lanes a leg, and
    not a multiple of them) equal one shot of 14 samples, codes, samples
    and state, at every rate: the state carries exactly however short the
    tick."""
    pcm = _legs(14)[:3]
    for bits in RATES:
        one, st1 = kernels.g726_encode_reference(torch.from_numpy(pcm), tg.g726_state(3), bits)
        dec1, ds1 = kernels.g726_decode_reference(one, tg.g726_state(3), bits)
        st, ds = tg.g726_state(3), tg.g726_state(3)
        parts, dparts = [], []
        for k in range(0, 14, tick):
            c, _ = tg.g726_encode(torch.from_numpy(pcm[:, k:k + tick].copy()), st, bits)
            parts.append(c)
            dparts.append(tg.g726_decode(c, ds, bits)[0])
        assert torch.equal(torch.cat(parts, dim=1), one), bits
        assert torch.equal(torch.cat(dparts, dim=1), dec1), bits
        for k in kernels.G726_KEYS:
            assert torch.equal(st[k], st1[k]) and torch.equal(ds[k], ds1[k]), (bits, k)


def test_legs_are_independent():
    pcm = _speech(800)[None]
    batch = np.concatenate([pcm, pcm // 3], axis=0)
    codes, _ = tg.g726_encode(torch.from_numpy(batch), tg.g726_state(2), 4)
    solo, _ = tg.g726_encode(torch.from_numpy(pcm), tg.g726_state(1), 4)
    assert torch.equal(codes[0], solo[0])


def test_codes_off_the_table_read_its_last_entry():
    """A code outside [0, 2^bits) (a corrupt payload) decodes as the JAX
    package's clamped gather does, not with an index error."""
    codes = np.array([[0, 15, 16, 200, 7, 8, 65535, 3]], np.int32)
    jd, _ = jg.g726_decode(jnp.asarray(codes), jg.g726_state(1), 4)
    td, _ = tg.g726_decode(torch.from_numpy(codes), tg.g726_state(1), 4)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=PCM_ATOL)


@pytest.mark.parametrize("bits", RATES)
def test_rfc3551_packing_equals_jax(bits):
    n = 80
    rng = np.random.default_rng(bits)
    codes = rng.integers(0, 1 << bits, n).astype(np.int32)
    data = tg.pack_codes(codes, bits)
    assert data == jg.pack_codes(codes, bits)
    assert len(data) == (n * bits + 7) // 8
    np.testing.assert_array_equal(tg.unpack_codes(data, bits, n), codes)
    np.testing.assert_array_equal(tg.unpack_codes(data, bits, n),
                                  jg.unpack_codes(data, bits, n))


def test_filters_registered():
    f = Factory()
    for kbps in (16, 24, 32, 40):
        assert f.lookup(f"g726_{kbps}_enc").implements("audio_encoder")
        assert f.lookup(f"g726_{kbps}_dec").implements("audio_decoder")


@pytest.mark.parametrize("bits", [2, 4])
def test_state_crosses_the_packages_both_ways(bits):
    """A g726 state as a flat dict of float32 leaves: JAX -> port
    (``from_jax``) and port -> JAX (``to_numpy``), dtype kept; each package
    continues from the other's state with equal codes."""
    pcm = _legs(480)[:2]
    a, b = pcm[:, :240], pcm[:, 240:]
    _, jst = jg.g726_encode(jnp.asarray(a), jg.g726_state(2), bits)
    tst = from_jax({k: np.asarray(v) for k, v in jst.items()}, "cpu")
    assert all(v.dtype == torch.float32 for v in tst.values())
    tc, _ = tg.g726_encode(torch.from_numpy(b.copy()), tst, bits)
    jc, _ = jg.g726_encode(jnp.asarray(b), jst, bits)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    _, tst2 = tg.g726_encode(torch.from_numpy(a.copy()), tg.g726_state(2), bits)
    back = to_numpy(tst2)
    assert all(v.dtype == np.float32 for v in back.values())
    jc2, _ = jg.g726_encode(jnp.asarray(b), {k: jnp.asarray(v) for k, v in back.items()}, bits)
    np.testing.assert_array_equal(np.asarray(jc2), np.asarray(jc))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    meta = torch.zeros((1, 80), dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="no kernel"):
        kernels.g726_encode(meta, tg.g726_state(1), 4)
    assert {"g726_encode", "g726_decode"} <= set(kernels.launch_counts())
