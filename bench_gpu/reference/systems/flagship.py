"""The reference of ``systems/flagship.py``: mic and speaker reference at
``rate`` -> EC -> AGC -> ``mix_rate`` -> mix-minus in groups of
``conf_size``. Outputs {"out"} f32 [B, mix_rate / 100]."""
from __future__ import annotations

from bench_gpu.reference import graphs


def init_state(cfg, B, device):
    return graphs.core_init(cfg, B, device)


def tick(pr, cfg, st, ins, batch, legs):
    new = {}
    mix, flags = graphs.core(pr, cfg, st, new, ins["mic"], ins["spk_ref"], batch, legs)
    return new, {"out": mix}, flags
