"""Synthetic test/bench signals (a copy of ``mediastreamer2_tpu/utils/signals.py``,
numpy only; replaces the reference's tester/sounds fixtures)."""
from __future__ import annotations

from typing import Iterable, Union

import numpy as np


def make_speechlike(n: int, rate: int, seed: Union[int, Iterable[int]] = 0,
                    channels: int = 1) -> np.ndarray:
    """AM-modulated harmonic stack + noise bursts — speech-shaped energy.

    ``seed`` may be a sequence of seeds: the result is then [len(seed), n
    * channels], row i the signal of ``seed[i]`` (the harmonic stack, the
    same for every seed, computed once; the rest 128 seeds at a time)."""
    t = np.arange(n) / rate
    f0 = 110.0 + 30.0 * np.sin(2 * np.pi * 0.7 * t)
    phase = 2 * np.pi * np.cumsum(f0) / rate
    stack = sum((0.5 / k) * np.sin(k * phase) for k in range(1, 6))
    seeds = [seed] if np.isscalar(seed) else list(seed)
    out = np.empty((len(seeds), n), np.float32)
    for lo in range(0, len(seeds), 128):
        rngs = [np.random.default_rng(s) for s in seeds[lo:lo + 128]]
        shift = np.array([r.uniform(0, 6.28) for r in rngs])[:, None]
        noise = np.stack([r.standard_normal(n) for r in rngs])
        env = 0.5 * (1 + np.sin(2 * np.pi * 1.3 * t + shift))
        sig = stack * env + 0.01 * noise
        out[lo:lo + len(rngs)] = 0.5 * sig / np.max(np.abs(sig), axis=1, keepdims=True)
    if channels > 1:
        out = np.repeat(out[:, :, None], channels, axis=2).reshape(len(seeds), -1)
    return out[0] if np.isscalar(seed) else out
