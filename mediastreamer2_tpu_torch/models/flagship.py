"""Flagship pipeline: the 48 kHz AEC + resample + mix conference leg
(port of ``mediastreamer2_tpu/models/flagship.py``).

Every leg runs mic -> echo cancellation (48 kHz, 80 ms tail) -> AGC volume
-> polyphase resample 48k->16k -> N-way conference mix-minus.
"""
from __future__ import annotations

import numpy as np
import torch

from mediastreamer2_tpu_torch.core.block import Format, tick_samples
from mediastreamer2_tpu_torch.core.graph import GraphBuilder


def build_flagship(factory, batch: int, device, rate: int = 48000,
                   mix_rate: int = 16000, conf_size: int = 4,
                   tail_ms: int = 80):
    """Returns (CompiledGraph, params on ``device``) with conference groups
    of ``conf_size`` contiguous legs."""
    g = GraphBuilder(factory, batch=batch)
    mic = g.add("ext_source", "mic", fmt=Format(rate=rate))
    spk = g.add("ext_source", "spk_ref", fmt=Format(rate=rate))
    ec = g.add("echo_canceller", "ec", tail_ms=tail_ms)
    agc = g.add("volume", "agc")
    rs = g.add("resample", "rs", out_rate=mix_rate)
    mix = g.add("conf_mixer", "conf", sorted_groups=True,
                uniform_group_size=conf_size)
    out = g.add("ext_sink", "out")
    g.link(mic, 0, ec, 0)
    g.link(spk, 0, ec, 1)
    g.chain(ec, agc, rs, mix, out)
    cg = g.build()
    params = cg.init_params(device)
    params["agc"]["agc_enabled"] = torch.ones((batch,), dtype=torch.bool, device=device)
    params["conf"]["group_id"] = torch.arange(batch, dtype=torch.int32,
                                              device=device) // conf_size
    return cg, params


def example_inputs(batch: int, rate: int = 48000, seed: int = 0):
    """One tick of random mic and speaker blocks, as numpy arrays."""
    S = tick_samples(rate)
    rng = np.random.default_rng(seed)
    return {
        "mic": (0.1 * rng.standard_normal((batch, S))).astype(np.float32),
        "spk_ref": (0.1 * rng.standard_normal((batch, S))).astype(np.float32),
    }


def echo_coupled_inputs(batch: int, ticks: int, rate: int = 48000, seed: int = 7):
    """The cross-backend fixture of ``tools/tpu_correctness.py:50-55``: a
    white far end (0.2 rms), near-end noise (0.05 rms) and an echo of half
    the far end delayed by 400 samples. Returns (mic, far), numpy
    [batch, ticks * samples_per_tick] float32."""
    S = tick_samples(rate)
    rng = np.random.default_rng(seed)
    far = (0.2 * rng.standard_normal((batch, ticks * S))).astype(np.float32)
    near = (0.05 * rng.standard_normal((batch, ticks * S))).astype(np.float32)
    echo = 0.5 * np.roll(far, 400, axis=1)
    return (near + echo).astype(np.float32), far
