"""Audio similarity oracle (a copy of ``audio_diff`` from
``mediastreamer2_tpu/utils/audiodiff.py``, which cannot be imported without
jax, batched over rows in torch): the reference's ``ms_audio_diff``, a
normalized peak cross-correlation searched over time shifts, computed by FFT.
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
