"""Audio similarity oracles (a port of ``mediastreamer2_tpu/utils/audiodiff.py``,
which cannot be imported without jax): ``audio_diff``, the reference's
``ms_audio_diff``, a normalized peak cross-correlation searched over time
shifts, computed by FFT and batched over rows in torch; the silence
detector and ``ms_audio_compare_silence_and_speech`` built on it; energy
and SNR in dB. Every alignment here goes through this module's
``audio_diff``.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def audio_diff(ref, rec, max_shift: int | None = None, device="cpu") -> Tuple:
    """Normalized peak cross-correlation between ref and rec.

    ``ref`` and ``rec`` are [n] or, row i against row i, [rows, n] (numpy
    arrays or tensors), computed in float64 on ``device``. Returns
    (similarity, shift) where shift>0 means rec lags ref: a float and an
    int for 1-D input, numpy arrays [rows] for 2-D.
    Similarity ~1.0 for identical-up-to-delay-and-gain signals.
    """
    a, b = (torch.as_tensor(x if isinstance(x, torch.Tensor) else np.array(x, np.float64),
                            dtype=torch.float64, device=device) for x in (ref, rec))
    single = a.dim() == 1
    a, b = torch.atleast_2d(a), torch.atleast_2d(b)
    n = max(a.shape[1], b.shape[1])
    if n == 0:
        sims, shifts = np.zeros(a.shape[0]), np.zeros(a.shape[0], np.int64)
    else:
        a, b = a - a.mean(dim=1, keepdim=True), b - b.mean(dim=1, keepdim=True)
        size = 1 << (2 * n - 1).bit_length()
        xc = torch.fft.irfft(torch.fft.rfft(a, size).conj() * torch.fft.rfft(b, size), size)
        # valid lags: rec delayed by k in [0, n) -> xc[k]; rec early -> xc[size-k]
        lags = torch.cat([xc[:, :n], xc[:, size - n + 1:]], dim=1)
        if max_shift is not None:
            mask = torch.zeros(lags.shape[1], dtype=torch.bool, device=lags.device)
            mask[: max_shift + 1] = True
            mask[-max_shift:] = True
            lags = torch.where(mask, lags, -torch.inf)
        k = torch.argmax(lags, dim=1)
        denom = torch.sqrt((a * a).sum(dim=1) * (b * b).sum(dim=1))
        live = denom > 0
        sim = lags.gather(1, k[:, None])[:, 0] / torch.where(live, denom, 1.0)
        shift = torch.where(k < n, k, k - (2 * n - 1))
        sims = torch.where(live, sim.clamp(0.0, 1.0), 0.0).cpu().numpy()
        shifts = torch.where(live, shift, 0).cpu().numpy()
    if single:
        return float(sims[0]), int(shifts[0])
    return sims, shifts


def quality_bar(ref: np.ndarray, got: np.ndarray, leg_step: int = 37, device="cpu") -> dict:
    """The cross-backend bar of ``tools/tpu_correctness.py`` for two
    [legs, samples] output streams. ``pass`` needs the similarity of every
    ``leg_step``-th leg >= 0.999 (that tool samples legs 0, 37, 74, ...),
    rms error <= 5e-3 and the per-leg output energy gap over the second half
    <= 1.5 dB on every leg.

    The similarity of every leg is reported beside it: the echo canceller's
    promote decision can land a few ticks apart between backends on a leg
    whose evidence sits on the threshold, and for those ticks one backend
    outputs the promoted filter's residual and the other the main filter's
    (the mix-minus spreads that to the leg's conference). ``device``:
    where ``audio_diff`` runs (a card takes thousands of legs at once)."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    sims = audio_diff(ref, got, device=device)[0]
    err = np.abs(ref - got)
    rms = float(np.sqrt(np.mean(err ** 2)))
    half = ref.shape[1] // 2
    e_ref = (ref[:, half:] ** 2).mean(axis=1) + 1e-12
    e_got = (got[:, half:] ** 2).mean(axis=1) + 1e-12
    gap = float(np.abs(10 * np.log10(e_ref / e_got)).max())
    sampled = float(sims[::leg_step].min())
    return {"audio_diff_min": sampled, "audio_diff_min_all_legs": float(sims.min()),
            "legs_below_0.999": int((sims < 0.999).sum()), "rms_err": rms,
            "max_abs_err": float(err.max()), "energy_gap_db_max": gap,
            "pass": bool(sampled >= 0.999 and rms <= 5e-3 and gap <= 1.5)}


def silence_mask(ref: np.ndarray, threshold: float = 0.001,
                 half_window: int = 200,
                 smooth_half_window: int = 1400) -> np.ndarray:
    """Boolean silence mask of the reference signal: the reference's
    two-stage detector (audiodiff.c ms_audio_compute_energy_in_silence),
    a sliding mean of |x| below ``threshold``, then a majority vote over a
    wider window that removes speckle. Input whose peak is above 1.5 is
    taken as int16-scaled."""
    x = np.abs(np.asarray(ref, np.float64))
    if x.size and x.max() > 1.5:
        x = x / 32768.0
    n = len(x)
    if n == 0:
        return np.zeros(0, bool)
    idx = np.arange(n)
    csum = np.cumsum(np.concatenate([[0.0], x]))
    w0 = np.maximum(0, idx - half_window)
    wn = np.minimum(n, idx + half_window + 1)
    raw = ((csum[wn] - csum[w0]) / (wn - w0) < threshold).astype(np.float64)
    csum2 = np.cumsum(np.concatenate([[0.0], raw]))
    w0 = np.maximum(0, idx - smooth_half_window)
    wn = np.minimum(n, idx + smooth_half_window + 1)
    return (csum2[wn] - csum2[w0]) / (wn - w0) >= 0.5


def _aligned(ref: np.ndarray, rec: np.ndarray, shift: int):
    """``ref`` and ``rec`` cut to a common length after dropping the head
    of whichever lags by ``shift`` (``audio_diff``'s: > 0, rec lags)."""
    if shift > 0:
        rec = rec[shift:]
    elif shift < 0:
        ref = ref[-shift:]
    n = min(len(ref), len(rec))
    return ref[:n], rec[:n]


def audio_compare_silence_and_speech(ref: np.ndarray, rec: np.ndarray, rate: int,
                                     align_window_ms: tuple = (0, 2000)) -> Tuple[float, float]:
    """(speech similarity, silence energy): the reference's second test
    oracle ``ms_audio_compare_silence_and_speech`` (audiodiff.c /
    msutils.h:76). Aligns on ``align_window_ms`` by ``audio_diff``'s shift,
    finds the reference's silent spans (``silence_mask``), then returns the
    similarity over the speech samples only (shifts up to 1% of them) and
    the summed energy of ``rec`` over the silent ones (noise or echo put
    into the pauses)."""
    ref = np.asarray(ref, np.float64)
    rec = np.asarray(rec, np.float64)
    s0 = int(align_window_ms[0] * rate / 1000)
    s1 = min(int(align_window_ms[1] * rate / 1000), len(ref), len(rec))
    ref, rec = _aligned(ref, rec, audio_diff(ref[s0:s1], rec[s0:s1])[1])
    mask = silence_mask(ref)
    energy = float((rec[mask] ** 2).sum())
    speech = ~mask
    sim, _ = audio_diff(ref[speech], rec[speech], max_shift=max(1, int(speech.sum()) // 100))
    return sim, energy


def energy_db(x: np.ndarray) -> float:
    """Mean power of ``x`` in dB (1e-12 added: silence is -120 dB)."""
    x = np.asarray(x, np.float64)
    p = (x * x).mean() if len(x) else 0.0
    return 10.0 * np.log10(p + 1e-12)


def snr_db(ref: np.ndarray, test: np.ndarray, align: bool = True) -> float:
    """Signal-to-noise ratio of ``test`` against ``ref`` after the best
    gain, and with ``align`` after ``audio_diff``'s shift; ``-inf`` for a
    zero reference."""
    ref = np.asarray(ref, np.float64)
    test = np.asarray(test, np.float64)
    if align:
        ref, test = _aligned(ref, test, audio_diff(ref, test)[1])
    else:
        n = min(len(ref), len(test))
        ref, test = ref[:n], test[:n]
    denom = (ref * ref).sum()
    if denom == 0:
        return -np.inf
    g = (ref * test).sum() / ((test * test).sum() + 1e-30)
    err = ref - g * test
    return 10.0 * np.log10(denom / ((err * err).sum() + 1e-30))
