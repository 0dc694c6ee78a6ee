"""Real-pair DFTs (port of ``mediastreamer2_tpu/ops/rfft.py``): FFTs on
the card, matrix products on the CPU.

Spectra are (re, im) float32 pairs. Conventions match numpy.fft.rfft/irfft
(forward: X_k = sum x_n e^{-2pi i nk/N}). Each transform picks its path by
its input's device (``_fft_on``), as ``rowwise_mm`` picks its product:

* on a CUDA tensor it is an FFT through ``torch.fft`` (cuFFT): O(n log n)
  work where the product does O(n^2). cuFFT reads and writes interleaved
  complex spectra; one pass each way (``kernels.spectrum_planes``,
  ``kernels.planes_spectrum``) turns them into contiguous (re, im) planes of
  one [2, ..., F] tensor, which ``mdf_apply`` and ``mdf_update*`` need, and
  back. Per-bin factors ride along: a complex-to-real input is scaled by
  1/n (the transform runs unnormalised) and its imaginary parts at DC and
  Nyquist are zeroed, as the product's basis ignores them (its sin rows are
  zero there); ``rfft_tail`` pads at the end and takes the shift by n/2 as
  (-1)^k; ``irfft_tail`` keeps the last half; the constraint is an irfft,
  half the samples zeroed, and an rfft. cuFFT makes its plans at a shape's
  first call, so the first ticks (the warm-up) make them; a CUDA graph
  captured later needs them made before its capture.
* on the CPU it is a product with a constant cos/sin basis built in
  float64 with numpy, stored as float32, and cached per ``(n, device)``,
  through ``rowwise_mm``, so that the CPU tests hold the JAX package's bits.

``calls`` counts the calls by path (``"fft"``, ``"product"``), one a call,
as ``ops/kernels.py`` counts its launches.

Importing this module turns TF32 off for CUDA matmuls and cuDNN and sets
the float32 matmul precision to "highest": a TF32 product keeps about three
decimal digits, which the resampler's products and the echo canceller's
error spectra cannot afford.

Left out: the ``RFFT_BF16`` basis option (``ops/rfft.py:48`` of the JAX
package), measured neutral there and not part of the default semantics.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from mediastreamer2_tpu_torch.ops import kernels

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


ROW_BLOCK = 8


def rowwise_mm(x, w):
    """``x [..., K] @ w [K, N]``, with each row's bits independent of the
    number of rows in the call and of the row's place among them.

    On the CPU, MKL picks a float32 product's blocking from its row count,
    so one row of ``x @ w`` rounds differently in a call of 8 rows than in
    one of 2 or 1 (an AMD EPYC with AVX-512 and MKL 2024.2: 1-3 ulp on 93%
    of a flagship tick's outputs; ``MKL_CBWR=COMPATIBLE`` does not help). A
    leg shard holds a slice of the batch's rows, so its DFTs and resampler
    products would not equal the whole batch's bit for bit. Here the CPU
    product runs as a batch of fixed 8-row blocks, the last one zero-padded
    (``torch.bmm`` against ``w`` expanded over the blocks): every block is
    the same product, and on that host a row's bits depended neither on the
    row count, nor on its offset, nor on the thread count (1 or 8). It costs
    1.1-1.6x a plain product at 1,024 rows and a few microseconds a call at
    8 (``tools/cpu_product_cost.py``); ``tests/test_torch_row_invariance.py``
    holds the property at the flagship's and the session's sizes. On the
    card the product is plain ``x @ w``: shards run there with no cuBLAS
    workspace (``parallel/sharding.py``)."""
    if x.device.type != "cpu":
        return x @ w
    lead, k = x.shape[:-1], x.shape[-1]
    rows = x.reshape(-1, k)
    m = rows.shape[0]
    pad = (-m) % ROW_BLOCK
    if pad:
        rows = torch.cat([rows, rows.new_zeros((pad, k))])
    nb = rows.shape[0] // ROW_BLOCK
    y = torch.bmm(rows.reshape(nb, ROW_BLOCK, k), w.expand(nb, *w.shape))
    return y.reshape(-1, w.shape[1])[:m].reshape(*lead, w.shape[1])


@functools.lru_cache(maxsize=None)
def _fwd_np(n: int):
    k = np.arange(n // 2 + 1)
    t = np.arange(n)
    ang = 2 * np.pi * np.outer(t, k) / n            # [n, F]
    return (np.cos(ang).astype(np.float32),
            (-np.sin(ang)).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _inv_np(n: int):
    f = n // 2 + 1
    k = np.arange(f)
    t = np.arange(n)
    ang = 2 * np.pi * np.outer(k, t) / n            # [F, n]
    w = np.full(f, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    cw = (np.cos(ang) * w[:, None] / n).astype(np.float32)
    sw = (-np.sin(ang) * w[:, None] / n).astype(np.float32)
    return cw, sw


@functools.lru_cache(maxsize=None)
def _constraint_np(n: int):
    """The MDF gradient (causality) constraint -- irfft, zero the last n/2
    samples, rfft -- folded into one constant [F, F] complex operator,
    precomputed in float64."""
    f = n // 2 + 1
    k = np.arange(f)
    t = np.arange(n)
    ang_i = 2 * np.pi * np.outer(k, t) / n           # inverse [F, n]
    w = np.full(f, 2.0)
    w[0] = 1.0
    if n % 2 == 0:
        w[-1] = 1.0
    cw = np.cos(ang_i) * w[:, None] / n
    sw = -np.sin(ang_i) * w[:, None] / n
    ang_f = 2 * np.pi * np.outer(t, k) / n           # forward [n, F]
    c = np.cos(ang_f)
    s = -np.sin(ang_f)
    h = n // 2                                       # keep samples [0, h)
    return tuple((a @ b).astype(np.float32)
                 for a, b in ((cw[:, :h], c[:h]), (cw[:, :h], s[:h]),
                              (sw[:, :h], c[:h]), (sw[:, :h], s[:h])))


@functools.lru_cache(maxsize=None)
def _on(kind: str, n: int, device: torch.device):
    """The basis matrices of one kind, as contiguous tensors on ``device``."""
    mats = {"fwd": _fwd_np, "inv": _inv_np, "con": _constraint_np}[kind](n)
    h = n // 2
    if kind == "fwd":
        mats = mats + tuple(np.ascontiguousarray(m[h:]) for m in mats)
    elif kind == "inv":
        mats = mats + tuple(np.ascontiguousarray(m[:, h:]) for m in mats)
    return tuple(torch.from_numpy(m).to(device) for m in mats)


calls = {"fft": 0, "product": 0}


def _fft_on(t) -> bool:
    """The path rule: an FFT on the card, a basis product on the CPU."""
    return t.device.type != "cpu"


def _c2r(re, im, n: int):
    """irfft(re, im, n) by cuFFT: 1/n and the zeroed DC and Nyquist
    imaginary parts go in with the interleaving pass, so the transform runs
    unnormalised."""
    return torch.fft.irfft(kernels.planes_spectrum(re, im, n), n=n, norm="forward")


def rfft(x, n: int):
    """x [..., n] float32 -> (re, im) each [..., n//2+1]."""
    if _fft_on(x):
        calls["fft"] += 1
        return kernels.spectrum_planes(torch.fft.rfft(x, n=n))
    calls["product"] += 1
    c, s, _, _ = _on("fwd", n, x.device)
    return rowwise_mm(x, c), rowwise_mm(x, s)


def irfft(re, im, n: int):
    """(re, im) [..., n//2+1] -> x [..., n]."""
    if _fft_on(re):
        calls["fft"] += 1
        return _c2r(re, im, n)
    calls["product"] += 1
    cw, sw, _, _ = _on("inv", n, re.device)
    return rowwise_mm(re, cw) + rowwise_mm(im, sw)


def rfft_tail(x_tail, n: int):
    """rfft of [zeros(n/2), x_tail] without materializing the zeros (the
    MDF error-spectrum transform); n even. The FFT path pads at the end and
    turns the shift by n/2 into (-1)^k in the planes' pass."""
    if _fft_on(x_tail):
        if n % 2:
            raise ValueError(f"rfft_tail needs an even n, got {n}")
        calls["fft"] += 1
        return kernels.spectrum_planes(torch.fft.rfft(x_tail, n=n), alternate=True)
    calls["product"] += 1
    _, _, c_t, s_t = _on("fwd", n, x_tail.device)
    return rowwise_mm(x_tail, c_t), rowwise_mm(x_tail, s_t)


def irfft_tail(re, im, n: int):
    """Last n/2 samples of irfft(re, im, n) (the overlap-save output)."""
    if _fft_on(re):
        calls["fft"] += 1
        return _c2r(re, im, n)[..., n // 2:]
    calls["product"] += 1
    _, _, cw_t, sw_t = _on("inv", n, re.device)
    return rowwise_mm(re, cw_t) + rowwise_mm(im, sw_t)


def apply_constraint(re, im, n: int):
    """(re, im) -> constrained (re', im'): equivalent to
    rfft(irfft(re, im, n) with samples n//2: zeroed, n)."""
    if _fft_on(re):
        calls["fft"] += 1
        x = _c2r(re, im, n)
        x[..., n // 2:].zero_()
        return kernels.spectrum_planes(torch.fft.rfft(x))
    calls["product"] += 1
    arr, ari, air, aii = _on("con", n, re.device)
    return (rowwise_mm(re, arr) + rowwise_mm(im, air),
            rowwise_mm(re, ari) + rowwise_mm(im, aii))


def cmul(ar, ai, br, bi):
    """(ar+i ai)(br+i bi) -> (re, im)."""
    return ar * br - ai * bi, ar * bi + ai * br


def cmul_conj(ar, ai, br, bi):
    """conj(a) * b -> (re, im)."""
    return ar * br + ai * bi, ar * bi - ai * br


def cabs2(re, im):
    return re * re + im * im
