"""Audio similarity oracle (numpy copy of ``audio_diff`` from
``mediastreamer2_tpu/utils/audiodiff.py``, which cannot be imported without
jax): the reference's ``ms_audio_diff``, a normalized peak
cross-correlation searched over time shifts, computed by FFT.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _normalize(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float64)
    return x - x.mean()


def audio_diff(ref: np.ndarray, rec: np.ndarray,
               max_shift: int | None = None) -> Tuple[float, int]:
    """Normalized peak cross-correlation between ref and rec.

    Returns (similarity, shift) where shift>0 means rec lags ref.
    Similarity ~1.0 for identical-up-to-delay-and-gain signals.
    """
    a, b = _normalize(ref), _normalize(rec)
    n = max(len(a), len(b))
    if n == 0:
        return 0.0, 0
    size = 1 << (2 * n - 1).bit_length()
    fa = np.fft.rfft(a, size)
    fb = np.fft.rfft(b, size)
    xc = np.fft.irfft(fa.conj() * fb, size)
    # valid lags: rec delayed by k in [0, n) -> xc[k]; rec early -> xc[size-k]
    lags = np.concatenate([xc[: n], xc[size - n + 1:]])
    if max_shift is not None:
        mask = np.zeros_like(lags, dtype=bool)
        mask[: max_shift + 1] = True
        mask[-max_shift:] = True
        lags = np.where(mask, lags, -np.inf)
    k = int(np.argmax(lags))
    shift = k if k < n else k - (2 * n - 1)
    denom = np.sqrt((a * a).sum() * (b * b).sum())
    if denom == 0:
        return 0.0, 0
    sim = float(lags[k] / denom)
    return max(0.0, min(1.0, sim)), shift


def quality_bar(ref: np.ndarray, got: np.ndarray, leg_step: int = 37) -> dict:
    """The cross-backend bar of ``tools/tpu_correctness.py`` for two
    [legs, samples] output streams. ``pass`` needs the similarity of every
    ``leg_step``-th leg >= 0.999 (that tool samples legs 0, 37, 74, ...),
    rms error <= 5e-3 and the per-leg output energy gap over the second half
    <= 1.5 dB on every leg.

    The similarity of every leg is reported beside it: the echo canceller's
    promote decision can land a few ticks apart between backends on a leg
    whose evidence sits on the threshold, and for those ticks one backend
    outputs the promoted filter's residual and the other the main filter's
    (the mix-minus spreads that to the leg's conference)."""
    ref = np.asarray(ref, np.float64)
    got = np.asarray(got, np.float64)
    sims = np.array([audio_diff(ref[i], got[i])[0] for i in range(ref.shape[0])])
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
