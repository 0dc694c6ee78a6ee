"""The DFTs' FFT path (``ops/rfft.py``), which the card runs, on the CPU.

The path is chosen by the tensor's device; here the rule is patched so
that CPU tensors take it. Each of the five transforms stays within 3e-6
of each row's peak of the basis product (the CPU's path, which the JAX
parity tests hold), on spectra whose DC and Nyquist bins carry imaginary
parts that the product ignores; a row's bits depend neither on the rows
around it nor on their count; the echo canceller on FFTs converges as it
does on products."""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import numpy as np  # noqa: E402

from conftest import make_speechlike  # noqa: E402
from test_aec import RATE, S, erle_db, room_ir  # noqa: E402
from test_torch_aec import port_simulate  # noqa: E402
from mediastreamer2_tpu_torch.ops import rfft  # noqa: E402

B = 8
SIZES = (160, 320, 480, 960)
DFTS = ("rfft", "irfft", "rfft_tail", "irfft_tail", "apply_constraint")


def _rows(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def _case(name, n, rows=B):
    """(the transform on its arguments, its arguments) at ``rows`` rows;
    spectra's DC and Nyquist imaginary parts are far from zero."""
    f = n // 2 + 1
    im = _rows((rows, f), 2)
    im[:, 0] = 3.0
    im[:, -1] = -2.0
    spec = (_rows((rows, f), 1), im)
    return {"rfft": (lambda x: rfft.rfft(x, n), (_rows((rows, n), 0),)),
            "irfft": (lambda r, i: rfft.irfft(r, i, n), spec),
            "rfft_tail": (lambda x: rfft.rfft_tail(x, n), (_rows((rows, n // 2), 3),)),
            "irfft_tail": (lambda r, i: rfft.irfft_tail(r, i, n), spec),
            "apply_constraint": (lambda r, i: rfft.apply_constraint(r, i, n), spec)}[name]


def _tuple(out):
    return out if isinstance(out, tuple) else (out,)


@pytest.fixture
def fft_path(monkeypatch):
    monkeypatch.setattr(rfft, "_fft_on", lambda t: True)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", DFTS)
def test_fft_path_matches_the_product_path(monkeypatch, name, n):
    fn, args = _case(name, n)
    want = _tuple(fn(*args))
    monkeypatch.setattr(rfft, "_fft_on", lambda t: True)
    before = dict(rfft.calls)
    got = _tuple(fn(*args))
    assert rfft.calls["fft"] == before["fft"] + 1
    assert rfft.calls["product"] == before["product"]
    peak = torch.stack([w.abs().amax(dim=-1) for w in want]).amax(dim=0)[:, None]
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert float(((g - w).abs() / peak).max()) <= 3e-6


@pytest.mark.parametrize("name", ("rfft", "rfft_tail", "apply_constraint"))
def test_fft_path_spectra_are_contiguous_planes(fft_path, name):
    """mdf_apply and mdf_update* take contiguous (re, im) planes only."""
    fn, args = _case(name, 960)
    re, im = fn(*args)
    assert re.is_contiguous() and im.is_contiguous()


@pytest.mark.parametrize("n", (160, 960))
@pytest.mark.parametrize("name", DFTS)
def test_fft_path_rows_are_bit_equal_at_every_row_count_and_offset(fft_path, name, n):
    fn, args = _case(name, n)
    full = _tuple(fn(*args))
    for m in range(1, B + 1):
        for off in range(B - m + 1):
            part = _tuple(fn(*(a[off:off + m].clone() for a in args)))
            for p, f in zip(part, full):
                assert torch.equal(p.contiguous().view(torch.int32),
                                   f[off:off + m].contiguous().view(torch.int32)), (m, off)


def test_fft_path_ignores_dc_and_nyquist_imaginary_parts(fft_path):
    """As the product's basis does: their sin rows are zero."""
    n = 960
    re, im = _case("irfft", n)[1]
    zeroed = im.clone()
    zeroed[:, [0, -1]] = 0.0
    for fn in (rfft.irfft, rfft.irfft_tail, rfft.apply_constraint):
        for a, b in zip(_tuple(fn(re, im, n)), _tuple(fn(re, zeroed, n))):
            assert torch.equal(a, b)


def test_fft_path_rfft_tail_refuses_an_odd_n(fft_path):
    """The shift by n/2 is (-1)^k only for an even n."""
    with pytest.raises(ValueError, match="even n"):
        rfft.rfft_tail(_rows((2, 80), 4), 161)


def _echo_fixture(ticks, seed=0):
    """tests/test_aec.py's room echo of a speech-like far end (16 kHz)."""
    rng = np.random.default_rng(seed)
    n = S * ticks
    far = make_speechlike(n, RATE, seed=seed)
    echo = np.convolve(far, room_ir(rng, 400))[:n].astype(np.float32)
    near = echo + 1e-4 * rng.standard_normal(n).astype(np.float32)
    return near, far, echo


def test_aec_on_ffts_converges_as_on_products(monkeypatch):
    """300 echo-coupled ticks: converged ERLE above 15 dB and within 2 dB
    of the product path's (tests/test_torch_aec.py's bars), 8 DFT calls a
    tick, all FFTs."""
    ticks = 300
    near, far, echo = _echo_fixture(ticks)
    out_product, _, _ = port_simulate(near, far, B=2, ticks=ticks)
    monkeypatch.setattr(rfft, "_fft_on", lambda t: True)
    before = dict(rfft.calls)
    out_fft, st, _ = port_simulate(near, far, B=2, ticks=ticks)
    assert rfft.calls == {"fft": before["fft"] + 8 * ticks, "product": before["product"]}
    assert all(bool(torch.isfinite(v.float()).all()) for v in st["ec"].values())
    converged = slice(150 * S, 300 * S)
    e_fft = erle_db(echo, out_fft, converged)
    e_product = erle_db(echo, out_product, converged)
    assert e_fft > 15, f"converged ERLE on FFTs {e_fft:.1f} dB"
    assert abs(e_fft - e_product) < 2.0, (e_fft, e_product)
