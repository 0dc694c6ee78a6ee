"""What the reference's systems share, and the loader that finds a
configuration's reference system by its ``system`` name:
``reference/systems/<system>.py``, which gives ``init_state(cfg, B,
device)`` and ``tick(pr, cfg, state, ins, batch, legs)`` (``legs``: the
global indices of the rows held, a LongTensor; ``batch``: the whole batch's
leg count). States carry the port's node and key names, so a state read
from the program steps in the reference unchanged.

Frozen at commit 19e7661 from ``mediastreamer2_tpu_torch/models/flagship.py``
(``build_flagship``), ``models/e2e_bench.py`` (``build_e2e_graph``,
``e2e_tick``) and ``ops/aec.py`` (the shadow's and the update's rules).
"""
from __future__ import annotations

import torch

from bench_gpu import files
from bench_gpu.reference import ops


def system(cfg):
    """The reference system of a configuration; an unknown one is an
    error."""
    return files.by_name("reference/systems", cfg["system"], "reference system")


def partitions(cfg) -> int:
    return max(1, -(-int(cfg["tail_ms"]) // 10))


def bf16_shadow(cfg) -> bool:
    """The shadow taps' type, from the environment the configuration sets,
    by the port's rule: bf16 unless ``AEC_BF16_SHADOW=0``, ``PALLAS_MDF=1``
    or ``AEC_PALLAS_UPDATE=1``."""
    env = cfg["env"]
    return (env.get("AEC_BF16_SHADOW", "1") != "0" and env.get("PALLAS_MDF", "0") != "1"
            and env.get("AEC_PALLAS_UPDATE", "0") != "1")


def aec_shape(cfg):
    """(P partitions, F bins, bytes of a shadow tap)."""
    return partitions(cfg), ops.tick_samples(cfg["rate"]) + 1, 2 if bf16_shadow(cfg) else 4


def megakernel(cfg, batch: int) -> bool:
    """The update path: the megakernel update where ``PALLAS_MDF=1``,
    ``PALLAS_DISABLE`` is not 1 and the batch tiles (B <= 32 or B % 32 == 0)."""
    env = cfg["env"]
    return (env.get("PALLAS_MDF", "0") == "1" and env.get("PALLAS_DISABLE", "0") != "1"
            and (batch <= 32 or batch % 32 == 0))


def row_base(cfg, legs):
    """Linear index of each leg's first tap in the whole [B, P, F] batch."""
    S = ops.tick_samples(cfg["rate"])
    return torch.as_tensor(legs, dtype=torch.int64) * partitions(cfg) * (S + 1)


def core_init(cfg, B, device):
    """The state of the EC -> AGC -> resample core."""
    S = ops.tick_samples(cfg["rate"])
    return {"ec": ops.aec_init(B, S, partitions(cfg), bf16_shadow(cfg), device),
            "agc": ops.volume_init(B, device),
            "rs": ops.resample_init(B, cfg["rate"], cfg["mix_rate"], device)}


def core(pr, cfg, st, new, mic, far, batch, legs):
    """EC -> AGC -> rate -> mix_rate -> mix-minus (the flagship's core):
    (the mix, the AEC's flags); fills ``new`` with the core's state."""
    rows = row_base(cfg, legs).to(mic.device)
    new["ec"], e, flags = ops.aec_step(pr, st["ec"], mic, far, megakernel(cfg, batch), rows)
    new["agc"], v = ops.volume_step(st["agc"], e)
    new["rs"], r = ops.resample_step(pr, st["rs"], v, cfg["rate"], cfg["mix_rate"])
    return ops.mix_minus(r, int(cfg["conf_size"])), flags
