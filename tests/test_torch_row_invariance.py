"""A leg's result does not depend on the batch around it, on the CPU.

The port's CPU matrix products (``ops/rfft.py``'s DFTs and the resampler,
through ``rowwise_mm``) give a row the same bits at every row count 1..8
and every offset, at the flagship's (n = 960, F = 481) and the session's
(n = 160, F = 81) sizes, and stay within float32 rounding of the JAX
package's DFTs. The plain versions of fused_volume and mdf_apply on an
[8, ...] batch equal themselves on its four [2, ...] row slices, the
property ``chip_smoke.py`` phase 2 holds the kernels to on the card
(``_slices_equal``). A leg shard holds a slice of the batch's rows, so its
legs equal the whole batch's only if this holds."""
import importlib.util
import os
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from mediastreamer2_tpu.ops import rfft as jrfft  # noqa: E402
from mediastreamer2_tpu_torch.core.block import Format  # noqa: E402
from mediastreamer2_tpu_torch.ops import kernels, rfft  # noqa: E402
from mediastreamer2_tpu_torch.ops.resample import _resample_init, _resample_process  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 8
SIZES = (960, 160)                  # 2S: the flagship's F = 481, the session's F = 81


def _rows(shape, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((scale * rng.standard_normal(shape)).astype(np.float32))


def _same_bits_per_row(fn, args):
    """fn on every run of 1..B consecutive rows of ``args`` equals those
    rows of fn on all B, bit for bit."""
    full = fn(*args)
    full = full if isinstance(full, tuple) else (full,)
    for m in range(1, B + 1):
        for off in range(B - m + 1):
            part = fn(*(a[off:off + m] for a in args))
            part = part if isinstance(part, tuple) else (part,)
            for p, f in zip(part, full):
                assert torch.equal(p.view(torch.int32), f[off:off + m].view(torch.int32)), \
                    (m, off)


def _dft_cases(n):
    f = n // 2 + 1
    spec = (_rows((B, f), 1), _rows((B, f), 2))
    return {
        "rfft": (lambda x: rfft.rfft(x, n), (_rows((B, n), 0),),
                 lambda x: jrfft.rfft(jnp.asarray(x), n)),
        "irfft": (lambda r, i: rfft.irfft(r, i, n), spec,
                  lambda r, i: jrfft.irfft(jnp.asarray(r), jnp.asarray(i), n)),
        "rfft_tail": (lambda x: rfft.rfft_tail(x, n), (_rows((B, n // 2), 3),),
                      lambda x: jrfft.rfft_tail(jnp.asarray(x), n)),
        "irfft_tail": (lambda r, i: rfft.irfft_tail(r, i, n), spec,
                       lambda r, i: jrfft.irfft_tail(jnp.asarray(r), jnp.asarray(i), n)),
        "apply_constraint": (lambda r, i: rfft.apply_constraint(r, i, n), spec,
                             lambda r, i: jrfft.apply_constraint(jnp.asarray(r),
                                                                 jnp.asarray(i), n)),
    }


DFTS = ("rfft", "irfft", "rfft_tail", "irfft_tail", "apply_constraint")


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", DFTS)
def test_dft_rows_are_bit_equal_at_every_row_count_and_offset(name, n):
    fn, args, _ = _dft_cases(n)[name]
    _same_bits_per_row(fn, args)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("name", DFTS)
def test_dft_matches_jax(name, n):
    """The blocked products stay float32 DFTs: within 2e-5 (relative to
    the output's scale) of the JAX package's on the same rows."""
    fn, args, jfn = _dft_cases(n)[name]
    got = fn(*args)
    want = jfn(*(a.numpy() for a in args))
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=2e-5 * np.abs(w).max())


@pytest.mark.parametrize("k,n", [(960, 481), (481, 960), (160, 81), (81, 160)])
def test_rowwise_mm_rows_are_bit_equal_and_close_to_matmul(k, n):
    w = _rows((k, n), 5)
    x = _rows((B, k), 6)
    _same_bits_per_row(lambda a: rfft.rowwise_mm(a, w), (x,))
    torch.testing.assert_close(rfft.rowwise_mm(x, w), x @ w, rtol=1e-5, atol=1e-4)
    assert rfft.rowwise_mm(x[:, None], w).shape == (B, 1, n)     # leading dims kept


def _resampler(rate_in, rate_out, channels):
    ctx = types.SimpleNamespace(in_formats=(Format(rate=rate_in, channels=channels),),
                                params={"out_rate": rate_out}, batch=B)
    n_in = rate_in // 100 * channels
    x = _rows((B, n_in), 7, 0.3)
    hist = _resample_init(ctx, "cpu")["hist"] + _rows((B, 1), 8, 0.1)

    def run(h, xx):
        return _resample_process({"hist": h}, (xx,), None, ctx)[1][0]
    return run, (hist, x)


@pytest.mark.parametrize("rate_in,rate_out,channels",
                         [(8000, 48000, 1), (48000, 8000, 1), (16000, 8000, 1),
                          (8000, 16000, 2)])
def test_resampler_rows_are_bit_equal_at_every_row_count_and_offset(rate_in, rate_out,
                                                                      channels):
    run, args = _resampler(rate_in, rate_out, channels)
    _same_bits_per_row(run, args)


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)              # defines only; main() needs a card
    return mod


@pytest.mark.parametrize("S", [80, 160, 480])
def test_fused_volume_reference_equals_its_row_slices(smoke, S):
    x = _rows((B, S), 9, 0.5)
    g0, g1 = _rows((B,), 10).abs() + 0.1, _rows((B,), 11).abs() + 0.1
    dc = _rows((B,), 12, 0.05)
    on = torch.tensor([1.0, 0.0] * (B // 2))
    smoke._slices_equal("fused_volume", kernels.fused_volume_reference, (x, g0, g1, dc, on))


@pytest.mark.parametrize("F,shadow", [(81, torch.bfloat16), (161, torch.bfloat16),
                                      (481, torch.bfloat16), (481, torch.float32)])
def test_mdf_apply_reference_equals_its_row_slices(smoke, F, shadow):
    """In place on the history too: the four sums and the shifted Xh."""
    P = 8
    bf = lambda seed, s: _rows((B, P, F), seed, s).to(torch.bfloat16)   # noqa: E731
    args = (bf(13, 0.1), bf(14, 0.1), bf(15, 0.1).to(shadow), bf(16, 0.1).to(shadow),
            bf(17, 1.0), bf(18, 1.0), _rows((B, F), 19), _rows((B, F), 20))
    smoke._slices_equal("mdf_apply", kernels.mdf_apply_reference, args)


def test_slices_equal_catches_a_leg_that_reads_the_batch(smoke):
    """The check fails a function whose rows depend on the batch around
    them (a mean over the whole batch)."""
    x = _rows((B, 80), 21)
    with pytest.raises(AssertionError, match="row slices"):
        smoke._slices_equal("batch mean", lambda a: (a - a.mean(),), (x,))


def test_ragged_checks_hold_the_plain_versions_on_the_cpu(smoke, capsys):
    """Phase 2's check of the kernels' unaligned paths (rows of 441
    floats, planes of P * F % 8 != 0) runs on the CPU's plain versions."""
    g = torch.Generator().manual_seed(0)
    smoke.ragged_checks(kernels, "cpu", lambda *shape, s=1.0: s * torch.randn(shape, generator=g))
    assert "kernel scalar paths" in capsys.readouterr().out
