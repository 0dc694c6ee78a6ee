"""G.722 (64 kbit/s SB-ADPCM, ITU-T G.722): QMF and two-band ADPCM (port of
``mediastreamer2_tpu/ops/g722.py``; the reference's msg722.c around the
bundled ITU g722_encode.c / g722_decode.c).

The per-sample recurrence runs in one launch per tick on the card: the
hand-written kernels ``g722_encode`` / ``g722_decode`` of ``ops/kernels.py``
(one thread per leg, the 80 code slots of a tick in a loop), where the JAX
package runs a ``lax.scan``. On the CPU the same wrappers run the plain slot
loop in torch int32, which the tests hold to the JAX package bit for bit.

State per leg (``g722_state``, the JAX package's keys, all int32): two
bands ``lo`` / ``hi`` of ``s, sp, sz, r[3], a[3], p[3], d[7], b[7], nb,
det``, and the QMF delay line ``x[24]``. The kernels update it in place.

RTP quirk (RFC 3551 §4.5.2): payload type 9 runs 16 kHz audio on an 8 kHz
RTP clock; the encoder's output format halves the rate (one code byte per
8 kHz slot) and the decoder's doubles it back.

The ITU tables are copied from the JAX package (the port imports nothing
of it).
"""
from __future__ import annotations

import torch

from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter
from mediastreamer2_tpu_torch.ops.g711 import float_to_pcm16, pcm16_to_float
from mediastreamer2_tpu_torch.ops.kernels import g722_decode, g722_encode

__all__ = ["g722_state", "g722_encode", "g722_decode", "g722_tables"]

# --- ITU G.722 tables --------------------------------------------------------
_Q6 = (0, 35, 72, 110, 150, 190, 233, 276, 323, 370, 422, 473, 530, 587, 650,
       714, 786, 858, 940, 1023, 1121, 1219, 1339, 1458, 1612, 1765, 1980,
       2195, 2557, 2919, 0, 0)
_ILN = (0, 63, 62, 31, 30, 29, 28, 27, 26, 25, 24, 23, 22, 21, 20, 19, 18, 17,
        16, 15, 14, 13, 12, 11, 10, 9, 8, 7, 6, 5, 4, 0)
_ILP = (0, 61, 60, 59, 58, 57, 56, 55, 54, 53, 52, 51, 50, 49, 48, 47, 46, 45,
        44, 43, 42, 41, 40, 39, 38, 37, 36, 35, 34, 33, 32, 0)
_WL = (-60, -30, 58, 172, 334, 538, 1198, 3042)
_RL42 = (0, 7, 6, 5, 4, 3, 2, 1, 7, 6, 5, 4, 3, 2, 1, 0)
_ILB = (2048, 2093, 2139, 2186, 2233, 2282, 2332, 2383, 2435, 2489, 2543, 2599,
        2656, 2714, 2774, 2834, 2896, 2960, 3025, 3091, 3158, 3228, 3298, 3371,
        3444, 3520, 3597, 3676, 3756, 3838, 3922, 4008)
_WH = (0, -214, 798)
_RH2 = (2, 1, 2, 1)
_QM2 = (-7408, -1616, 7408, 1616)
_QM4 = (0, -20456, -12896, -8968, -6288, -4240, -2584, -1200,
        20456, 12896, 8968, 6288, 4240, 2584, 1200, 0)
_QM6 = (-136, -136, -136, -136, -24808, -21904, -19008, -16704, -14984, -13512,
        -12280, -11192, -10232, -9360, -8576, -7856, -7192, -6576, -6000, -5456,
        -4944, -4464, -4008, -3576, -3168, -2776, -2400, -2032, -1688, -1360,
        -1040, -728, 24808, 21904, 19008, 16704, 14984, 13512, 12280, 11192,
        10232, 9360, 8576, 7856, 7192, 6576, 6000, 5456, 4944, 4464, 4008, 3576,
        3168, 2776, 2400, 2032, 1688, 1360, 1040, 728, 432, 136, -432, -136)
_IHN = (0, 1, 0)
_IHP = (0, 3, 2)
_QMF = (3, -11, 12, 32, -210, 951, 3876, -805, 362, -156, 53, -11)

# the plain versions' tables; the two bands' tables of one lookup are
# concatenated, with each band's offset ([lower, higher]), and the per-band
# constants of the log scale factor are [lower, higher] pairs
_TABLES = {"q6": _Q6, "iln": _ILN, "ilp": _ILP, "rl42": _RL42, "ilb": _ILB, "rh2": _RH2,
           "qm2": _QM2, "qm4": _QM4, "qm6": _QM6, "ihn": _IHN, "ihp": _IHP,
           "qmf": _QMF, "qmf_rev": _QMF[::-1],
           "wl_wh": _WL + _WH, "wl_off": (0, len(_WL)),
           "qm4_qm2": _QM4 + _QM2, "qm_off": (0, len(_QM4)),
           "nb_max": (18432, 22528), "shift_base": (8, 10)}
_on_device: dict = {}


def g722_tables(device) -> dict:
    """The ITU tables as int32 tensors on ``device`` (made once per device),
    for the plain versions."""
    device = torch.device(device)
    if device not in _on_device:
        _on_device[device] = {k: torch.tensor(v, dtype=torch.int32, device=device)
                              for k, v in _TABLES.items()}
    return _on_device[device]


def _band_init(B, device, det):
    z = lambda *shape: torch.zeros((B,) + shape, dtype=torch.int32, device=device)  # noqa: E731
    return {"s": z(), "sp": z(), "sz": z(), "r": z(3), "a": z(3), "p": z(3),
            "d": z(7), "b": z(7), "nb": z(),
            "det": torch.full((B,), det, dtype=torch.int32, device=device)}


def g722_state(B: int, device="cpu") -> dict:
    """Fresh encoder or decoder state for ``B`` legs (the JAX package's
    ``g722_state``: det starts at 32 in the lower band, 8 in the upper)."""
    return {"lo": _band_init(B, device, 32), "hi": _band_init(B, device, 8),
            "x": torch.zeros((B, 24), dtype=torch.int32, device=device)}


# --- filter registration -----------------------------------------------------
def _g722_init(ctx, device):
    return g722_state(ctx.batch, device)


def _g722_enc_process(state, ins, params, ctx):
    codes, state = g722_encode(float_to_pcm16(ins[0]), state)
    return state, (codes,), {}


def _g722_dec_process(state, ins, params, ctx):
    pcm, state = g722_decode(ins[0].contiguous(), state)
    return state, (pcm16_to_float(pcm),), {}


register_filter(FilterDef(
    name="g722_enc", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0].with_(kind="g722",
                                                     rate=ctx.in_formats[0].rate // 2),),
    init=_g722_init, process=_g722_enc_process, interfaces=("audio_encoder",),
))
register_filter(FilterDef(
    name="g722_dec", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0].with_(kind="pcm",
                                                     rate=ctx.in_formats[0].rate * 2),),
    init=_g722_init, process=_g722_dec_process, interfaces=("audio_decoder",),
))
