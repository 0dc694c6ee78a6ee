"""Synthetic test/bench signals (a copy of ``mediastreamer2_tpu/utils/signals.py``,
numpy only; replaces the reference's tester/sounds fixtures)."""
from __future__ import annotations

import numpy as np


def make_speechlike(n: int, rate: int, seed: int = 0, channels: int = 1
                    ) -> np.ndarray:
    """AM-modulated harmonic stack + noise bursts — speech-shaped energy."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / rate
    f0 = 110.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / rate
    sig = sum((0.5 / k) * np.sin(k * phase) for k in range(1, 6))
    env = 0.5 * (1 + np.sin(2 * np.pi * 1.3 * t + rng.uniform(0, 6.28)))
    sig = sig * env + 0.01 * rng.standard_normal(n)
    sig = 0.5 * sig / np.max(np.abs(sig))
    if channels > 1:
        sig = np.repeat(sig[:, None], channels, axis=1).reshape(-1)
    return sig.astype(np.float32)
