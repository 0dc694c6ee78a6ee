"""DVI4 (IMA ADPCM, RFC 3551): 4 bits a sample (port of
``mediastreamer2_tpu/ops/adpcm.py``).

Standard IMA/DVI ADPCM: the step size adapts through an 89-entry table,
the encoder codes the difference to the prediction by successive
approximation against step, step/2 and step/4. The same algorithm as
CPython's ``audioop.lin2adpcm``, which the tests use as the oracle.

The per-sample recurrence runs in one launch per tick on the card: the
hand-written kernels ``dvi4_encode`` / ``dvi4_decode`` of ``ops/kernels.py``
(one thread per leg, the tick's samples in a loop), where the JAX package
runs a ``lax.scan``. On the CPU the same wrappers run the plain sample loop
in torch int32, bit for bit the JAX package's.

State per leg, the JAX package's keys: ``pred`` and ``index``, int32 [B];
the kernels update both in place.

The tables are copied from the JAX package (the port imports nothing of
it).
"""
from __future__ import annotations

import torch

from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter
from mediastreamer2_tpu_torch.ops.g711 import float_to_pcm16, pcm16_to_float
from mediastreamer2_tpu_torch.ops.kernels import dvi4_decode, dvi4_encode

__all__ = ["adpcm_encode", "adpcm_decode", "dvi4_tables"]

_STEP_TABLE = (
    7, 8, 9, 10, 11, 12, 13, 14, 16, 17, 19, 21, 23, 25, 28, 31, 34, 37, 41,
    45, 50, 55, 60, 66, 73, 80, 88, 97, 107, 118, 130, 143, 157, 173, 190,
    209, 230, 253, 279, 307, 337, 371, 408, 449, 494, 544, 598, 658, 724,
    796, 876, 963, 1060, 1166, 1282, 1411, 1552, 1707, 1878, 2066, 2272,
    2499, 2749, 3024, 3327, 3660, 4026, 4428, 4871, 5358, 5894, 6484, 7132,
    7845, 8630, 9493, 10442, 11487, 12635, 13899, 15289, 16818, 18500,
    20350, 22385, 24623, 27086, 29794, 32767)
_INDEX_TABLE = (-1, -1, -1, -1, 2, 4, 6, 8)
_on_device: dict = {}


def dvi4_tables(device) -> tuple:
    """(step table, index table) as int32 tensors on ``device`` (made once
    per device), for the plain versions."""
    device = torch.device(device)
    if device not in _on_device:
        _on_device[device] = tuple(torch.tensor(t, dtype=torch.int32, device=device)
                                   for t in (_STEP_TABLE, _INDEX_TABLE))
    return _on_device[device]


def adpcm_encode(pcm, pred, index):
    """pcm [B, S] int32 -> (codes [B, S] int32 0..15, pred, index); ``pred``
    and ``index`` are updated in place."""
    return dvi4_encode(pcm.contiguous(), pred, index)


def adpcm_decode(codes, pred, index):
    """codes [B, S] int32 -> (pcm [B, S] int32, pred, index); ``pred`` and
    ``index`` are updated in place."""
    return dvi4_decode(codes.contiguous(), pred, index)


def _adpcm_state(ctx, device):
    z = lambda: torch.zeros((ctx.batch,), dtype=torch.int32, device=device)  # noqa: E731
    return {"pred": z(), "index": z()}


def _enc_process(state, ins, params, ctx):
    codes, _, _ = adpcm_encode(float_to_pcm16(ins[0]), state["pred"], state["index"])
    return state, (codes,), {}


def _dec_process(state, ins, params, ctx):
    pcm, _, _ = adpcm_decode(ins[0], state["pred"], state["index"])
    return state, (pcm16_to_float(pcm),), {}


register_filter(FilterDef(
    name="dvi4_enc", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0].with_(kind="dvi4"),),
    init=_adpcm_state, process=_enc_process, category="encoder", enc_fmt="dvi4",
    interfaces=("audio_encoder",),
))
register_filter(FilterDef(
    name="dvi4_dec", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0].with_(kind="pcm"),),
    init=_adpcm_state, process=_dec_process, category="decoder", enc_fmt="dvi4",
    interfaces=("audio_decoder",),
))
