"""Generic packet-loss concealment + comfort-noise fill (port of
``mediastreamer2_tpu/ops/plc.py``).

Loss is signalled per leg per tick by the host jitter buffer through the
``lost`` param. A lost tick replays the last tick's output with geometric
decay and crossfades into comfort noise whose level tracks the last-heard
energy; the first tick after a loss crossfades back over 2.5 ms.

The control state lives on the host, where the jitter buffer decides
loss: the ``lost`` param, the per-leg ``lost_count`` and the threefry key
``rng`` are host leaves (see ``core/ticker.py``) whatever the graph's
device. Each tick the host works out every leg's decay, noise mix and
recovery flag and uploads them in one copy from pageable memory, which
the driver stages without waiting for the stream; the signal state
(``hist``, ``cn_level``) stays on the graph's device. So no tick reads
the device.

The comfort noise is JAX's: the key (the two uint32 key words in an
int64 tensor [2]) is split every tick, as in JAX, and the noise is
``jax.random.normal`` recomputed bit for bit by ``utils/prng.py`` (its
``erf_inv`` may differ by an ulp or two). The noise is drawn only on a
tick where some leg mixes it in (a loss of two ticks or more): elsewhere
its weight is 0 for every leg, and the output is the same.
"""
from __future__ import annotations

import torch

from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter
from mediastreamer2_tpu_torch.utils import prng

DECAY = 0.8          # per-tick decay of replayed waveform
CN_AFTER = 2         # ticks of loss before pure comfort noise


def _plc_init(ctx, device):
    B = ctx.batch
    S = ctx.in_formats[0].samples_per_tick
    return {
        "hist": torch.zeros((B, S), dtype=torch.float32, device=device),  # last tick out
        "lost_count": torch.zeros((B,), dtype=torch.int32),               # host
        "cn_level": torch.full((B,), 1e-4, dtype=torch.float32, device=device),
        "rng": prng.key(0),                                               # host
    }


def _plc_params(ctx, device):
    return {"lost": torch.zeros((ctx.batch,), dtype=torch.bool)}          # host


def _plc_process(state, ins, params, ctx):
    x = ins[0]
    B, S = x.shape
    lost = params["lost"]
    if lost.device.type != "cpu":
        raise ValueError("generic_plc: the 'lost' param is host data (a CPU tensor)")
    prev = state["lost_count"]
    lost_count = torch.where(lost, prev + 1, 0).to(torch.int32)
    cn_mix = torch.clamp((lost_count.to(torch.float32) - 1) / CN_AFTER, 0.0, 1.0)
    ctrl = torch.stack([lost.to(torch.float32), DECAY ** lost_count.to(torch.float32), cn_mix,
                        ((~lost) & (prev > 0)).to(torch.float32)]).to(x.device, non_blocking=True)
    lost_d, decay, recovered = ctrl[0] > 0, ctrl[1], ctrl[3] > 0
    keys = prng.split(state["rng"])

    concealed = state["hist"] * decay[:, None]
    if bool((cn_mix > 0).any()):
        # fade from waveform replay to comfort noise as loss persists
        noise = prng.normal(keys[1], (B, S), x.device) * state["cn_level"][:, None]
        mix = ctrl[2][:, None]
        concealed = concealed * (1 - mix) + noise * mix
    out = torch.where(lost_d[:, None], concealed, x)
    # crossfade the first 2.5 ms after recovery to avoid a discontinuity
    ramp_len = max(1, S // 4)
    k = torch.arange(S, dtype=torch.float32, device=x.device)[None, :]
    ramp = torch.clamp(k / ramp_len, 0.0, 1.0)
    out = torch.where(recovered[:, None], state["hist"] * DECAY * (1 - ramp) + x * ramp, out)

    good_rms = torch.sqrt((x * x).mean(dim=1))
    cn_level = torch.where(lost_d, state["cn_level"],
                           0.95 * state["cn_level"] + 0.05 * torch.clamp(good_rms, max=0.01))
    new_state = {"hist": out, "lost_count": lost_count, "cn_level": cn_level,
                 "rng": keys[0]}
    return new_state, (out,), {}


register_filter(FilterDef(
    name="generic_plc", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_plc_init, runtime_params=_plc_params, process=_plc_process,
))
