"""The reference of ``systems/e2e.py``: mu-law codes at ``codec_rate``
decoded -> ``rate`` (the far end) with the mic -> the flagship's core ->
``codec_rate`` -> mu-law. Outputs {"tx"} uint8 and {"out"} f32, both
[B, codec_rate / 100]."""
from __future__ import annotations

import torch

from bench_gpu.reference import graphs, ops


def init_state(cfg, B, device):
    st = graphs.core_init(cfg, B, device)
    st["up"] = ops.resample_init(B, cfg["codec_rate"], cfg["rate"], device)
    st["dn"] = ops.resample_init(B, cfg["mix_rate"], cfg["codec_rate"], device)
    return st


def tick(pr, cfg, st, ins, batch, legs):
    new = {}
    dec = ops.pcm16_to_float(ops.ulaw_decode(ins["codes"]))
    new["up"], far = ops.resample_step(pr, st["up"], dec, cfg["codec_rate"], cfg["rate"])
    mix, flags = graphs.core(pr, cfg, st, new, ins["mic"], far, batch, legs)
    new["dn"], out = ops.resample_step(pr, st["dn"], mix, cfg["mix_rate"], cfg["codec_rate"])
    tx = ops.ulaw_encode(ops.float_to_pcm16(out)).to(torch.uint8)
    return new, {"tx": tx, "out": out}, flags
