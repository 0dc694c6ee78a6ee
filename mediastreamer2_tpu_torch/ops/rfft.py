"""Real-pair DFTs as matrix products (port of ``mediastreamer2_tpu/ops/rfft.py``).

Spectra are (re, im) float32 pairs; every DFT is a product with a constant
cos/sin basis built in float64 with numpy, stored as float32, and cached
per ``(n, device)``. Conventions match numpy.fft.rfft/irfft (forward:
X_k = sum x_n e^{-2pi i nk/N}).

These products run outside any hand kernel, so they go to ``torch.matmul``.
Importing this module turns TF32 off for CUDA matmuls and cuDNN and sets
the float32 matmul precision to "highest": a TF32 product keeps about three
decimal digits, which the echo canceller's error spectra cannot afford.

Left out: the ``RFFT_BF16`` basis option (``ops/rfft.py:48`` of the JAX
package), measured neutral there and not part of the default semantics.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")


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


def rfft(x, n: int):
    """x [..., n] float32 -> (re, im) each [..., n//2+1]."""
    c, s, _, _ = _on("fwd", n, x.device)
    return x @ c, x @ s


def irfft(re, im, n: int):
    """(re, im) [..., n//2+1] -> x [..., n]."""
    cw, sw, _, _ = _on("inv", n, re.device)
    return re @ cw + im @ sw


def rfft_tail(x_tail, n: int):
    """rfft of [zeros(n/2), x_tail] without materializing the zeros (the
    MDF error-spectrum transform)."""
    _, _, c_t, s_t = _on("fwd", n, x_tail.device)
    return x_tail @ c_t, x_tail @ s_t


def irfft_tail(re, im, n: int):
    """Last n/2 samples of irfft(re, im, n) (the overlap-save output)."""
    _, _, cw_t, sw_t = _on("inv", n, re.device)
    return re @ cw_t + im @ sw_t


def apply_constraint(re, im, n: int):
    """(re, im) -> constrained (re', im'): equivalent to
    rfft(irfft(re, im, n) with samples n//2: zeroed, n)."""
    arr, ari, air, aii = _on("con", n, re.device)
    return re @ arr + im @ air, re @ ari + im @ aii


def cmul(ar, ai, br, bi):
    """(ar+i ai)(br+i bi) -> (re, im)."""
    return ar * br - ai * bi, ar * bi + ai * br


def cmul_conj(ar, ai, br, bi):
    """conj(a) * b -> (re, im)."""
    return ar * br + ai * bi, ar * bi - ai * br


def cabs2(re, im):
    return re * re + im * im
