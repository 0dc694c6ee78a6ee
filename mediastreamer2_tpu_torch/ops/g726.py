"""G.726 ADPCM at 16, 24, 32 and 40 kbit/s (port of
``mediastreamer2_tpu/ops/g726.py``; the reference's g726.c:170-205, eight
filter identities over spandsp's G.726).

The codec follows the ITU-T G.726 structure: log-domain quantizers with the
standard tables (x128 log2 domain), W / F scale-factor and speed
adaptation, fast and locked scale factors (``yu``, ``yl``, mixed by
``ap``), and the 2-pole / 6-zero adaptive predictor with the spec's
stability clamps. As in the JAX package the predictor runs in float32
instead of the spec's 11-bit FMULT, so it is G.726 in algorithm but not
bit-exact against the ITU vectors; encoder and decoder share the
reconstruction, so a round trip in the framework is exact.

The per-sample recurrence runs in one launch per tick on the card: the
hand-written kernels ``g726_encode`` / ``g726_decode`` of ``ops/kernels.py``
(one thread per leg, the rate a template parameter), where the JAX package
runs a ``lax.scan``. On the CPU the same wrappers run the plain sample loop
in torch float32, in the JAX package's association order.

State per leg (``g726_state``, the JAX package's keys, all float32): ``b``
[6], ``dq`` [6], ``a1``, ``a2``, ``sr1``, ``sr2``, ``p1``, ``p2``, ``yu``
(starts at 544), ``yl`` (34816), ``dms``, ``dml``, ``ap``, ``td``. The
kernels update it in place.

The tables are copied from the JAX package (the port imports nothing of
it).
"""
from __future__ import annotations

import numpy as np
import torch

from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter
from mediastreamer2_tpu_torch.core.ticker import resolve_device
from mediastreamer2_tpu_torch.ops.g711 import float_to_pcm16, pcm16_to_float
from mediastreamer2_tpu_torch.ops.kernels import g726_decode, g726_encode

__all__ = ["g726_state", "g726_encode", "g726_decode", "g726_tables", "pack_codes",
           "unpack_codes"]

# Per-rate tables (ITU G.726, scaled-by-128 log2 domain): qtab = decision
# thresholds, dqln = reconstruction levels, W = scale factor multipliers,
# F = speed weights. Keyed by bits a sample.
_RATE_TABLES = {
    2: {"qtab": (261,), "dqln": (116, 365), "W": (-22, 439), "F": (0, 7)},
    3: {"qtab": (-8, 171, 285), "dqln": (-2048, 135, 273, 373),
        "W": (-4, 30, 137, 582), "F": (0, 1, 2, 7)},
    4: {"qtab": (-124, 80, 178, 246, 300, 349, 400),
        "dqln": (-2048, 4, 135, 213, 273, 323, 373, 425),
        "W": (-12, 18, 41, 64, 112, 198, 355, 1122),
        "F": (0, 0, 0, 1, 1, 1, 3, 7)},
    5: {"qtab": (-122, -16, 67, 138, 197, 249, 297, 338, 377, 412, 444, 474, 501, 527, 552),
        "dqln": (-2048, -66, 28, 104, 169, 224, 274, 318, 358, 395, 429, 459, 488, 514,
                 539, 566),
        "W": (14, 14, 24, 39, 40, 41, 58, 100, 141, 179, 219, 280, 358, 440, 529, 696),
        "F": (0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 2, 3, 4, 5, 6, 6)},
}
_on_device: dict = {}


def g726_tables(bits: int, device) -> dict:
    """The rate's tables as float32 tensors on ``device`` (made once per
    rate and device), for the plain versions."""
    key = (bits, torch.device(device))
    if key not in _on_device:
        _on_device[key] = {k: torch.tensor(v, dtype=torch.float32, device=key[1])
                           for k, v in _RATE_TABLES[bits].items()}
    return _on_device[key]


def g726_state(B: int, device=None) -> dict:
    """Fresh encoder or decoder state for ``B`` legs on ``device`` (``None``:
    the card, as every entry point resolves it)."""
    device = resolve_device(device)
    z = lambda *s: torch.zeros((B,) + s, dtype=torch.float32, device=device)  # noqa: E731
    full = lambda v: torch.full((B,), v, dtype=torch.float32, device=device)  # noqa: E731
    return {
        "b": z(6), "dq": z(6),            # zero section
        "a1": z(), "a2": z(),             # pole section
        "sr1": z(), "sr2": z(), "p1": z(), "p2": z(),
        "yu": full(544.0),                # fast scale factor (log*128)
        "yl": full(34816.0),              # locked, extra <<6 precision
        "dms": z(), "dml": z(), "ap": z(),
        "td": z(),
    }


def pack_codes(codes: np.ndarray, bits: int) -> bytes:
    """Little-endian nibble packing per RFC 3551 §4.5.4 (aal2 ordering is
    the byte-reversed variant the reference also registers)."""
    flat = np.asarray(codes, np.uint8).reshape(-1)
    acc = 0
    nbits = 0
    out = bytearray()
    for c in flat:
        acc |= int(c) << nbits
        nbits += bits
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def unpack_codes(data: bytes, bits: int, n: int) -> np.ndarray:
    acc = 0
    nbits = 0
    out = np.zeros(n, np.int32)
    i = 0
    mask = (1 << bits) - 1
    for byte in data:
        acc |= byte << nbits
        nbits += 8
        while nbits >= bits and i < n:
            out[i] = acc & mask
            acc >>= bits
            nbits -= bits
            i += 1
    return out


# --- filter registration (the four rates, cf. g726.c:170-205) --------------
def _mk(bits, kbps):
    def init(ctx, device):
        return g726_state(ctx.batch, device)

    def enc_process(state, ins, params, ctx):
        codes, state = g726_encode(float_to_pcm16(ins[0]), state, bits)
        return state, (codes,), {}

    def dec_process(state, ins, params, ctx):
        pcm, state = g726_decode(ins[0].contiguous(), state, bits)
        return state, (pcm16_to_float(pcm),), {}

    register_filter(FilterDef(
        name=f"g726_{kbps}_enc", ninputs=1, noutputs=1,
        out_formats=lambda ctx: (ctx.in_formats[0].with_(kind=f"g726_{kbps}"),),
        init=init, process=enc_process, category="encoder",
        enc_fmt=f"g726_{kbps}", interfaces=("audio_encoder",),
    ))
    register_filter(FilterDef(
        name=f"g726_{kbps}_dec", ninputs=1, noutputs=1,
        out_formats=lambda ctx: (ctx.in_formats[0].with_(kind="pcm"),),
        init=init, process=dec_process, category="decoder",
        enc_fmt=f"g726_{kbps}", interfaces=("audio_decoder",),
    ))


for _bits, _kbps in ((2, 16), (3, 24), (4, 32), (5, 40)):
    _mk(_bits, _kbps)
