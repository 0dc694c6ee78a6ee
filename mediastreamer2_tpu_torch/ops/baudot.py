"""Baudot TTY (text telephone): FSK tone generation and detection (port of
``mediastreamer2_tpu/ops/baudot.py``; the reference's src/baudot/).

45.45 or 50 baud FSK carrying ITA2 5-bit codes (mark 1400 Hz, space
1800 Hz; 1 start, 5 data and 2 stop bits), used for accessibility
(TTY/TDD) over the audio path.

* Generation runs on the device: a per-leg bit schedule (uploaded by
  ``load_text``) drives a batched variable-frequency phase accumulator.
  State: ``bits`` [B, 512] float32, ``nbits`` int32, ``bit_pos`` and
  ``phase`` float32 [B]; params ``amplitude``, ``baud``, ``mute_input``.
* Detection: the device computes mark and space correlation envelopes over
  4 ms Hann windows, one every millisecond, as the events ``mark_env`` /
  ``space_env``; the start-bit / UART framing state machine consumes them
  on the host (``BaudotFramer``).

The ITA2 tables (US-TTY variant) are copied from the JAX package; LTRS /
FIGS shifting is the host codec's.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch

from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter

MARK_HZ = 1400.0
SPACE_HZ = 1800.0
DEFAULT_BAUD = 45.45

_LTRS = "\x00E\nA SIU\rDRJNFCKTZLWHYPQOBG\x0fMXV\x0e"
_FIGS = "\x003\n- \x0787\r$4',!:(5\")2#6019?&\x0f./;\x0e"
LTRS_SHIFT, FIGS_SHIFT = 0x1F, 0x1B


def char_to_code(ch: str, figs: bool):
    """Returns (code, needs_figs) or None."""
    ch = ch.upper()
    for table, is_figs in ((_LTRS, False), (_FIGS, True)):
        idx = table.find(ch)
        if idx >= 0 and idx not in (LTRS_SHIFT, FIGS_SHIFT):
            return idx, is_figs
    return None


def text_to_bits(text: str, stop_bits: float = 2.0) -> List[int]:
    """UART-style bit schedule: idle=mark(1), start=0, 5 data LSB-first,
    stop=mark."""
    bits: List[int] = [1] * 8          # leading idle marks
    figs = False

    def emit(code: int):
        bits.append(0)                                  # start
        bits.extend((code >> i) & 1 for i in range(5))  # LSB first
        bits.extend([1] * int(round(stop_bits)))        # stop

    emit(LTRS_SHIFT)                   # initial shift, like real TTYs
    for ch in text:
        m = char_to_code(ch, figs)
        if m is None:
            continue
        code, needs_figs = m
        if needs_figs != figs:
            emit(FIGS_SHIFT if needs_figs else LTRS_SHIFT)
            figs = needs_figs
        emit(code)
    bits.extend([1] * 8)
    return bits


def bits_to_text(decoded_codes: List[int]) -> str:
    out = []
    figs = False
    for code in decoded_codes:
        if code == LTRS_SHIFT:
            figs = False
        elif code == FIGS_SHIFT:
            figs = True
        else:
            ch = (_FIGS if figs else _LTRS)[code]
            if ch >= " " or ch in "\r\n":
                out.append(ch)
    return "".join(out)


MAX_BITS = 512


def _gen_init(ctx, device):
    B = ctx.batch
    return {
        "bits": torch.ones((B, MAX_BITS), dtype=torch.float32, device=device),   # mark idle
        "nbits": torch.zeros((B,), dtype=torch.int32, device=device),
        "bit_pos": torch.zeros((B,), dtype=torch.float32, device=device),  # fractional bit index
        "phase": torch.zeros((B,), dtype=torch.float32, device=device),
    }


def _gen_params(ctx, device):
    B = ctx.batch
    return {"amplitude": torch.full((B,), 0.4, dtype=torch.float32, device=device),
            "baud": torch.full((B,), DEFAULT_BAUD, dtype=torch.float32, device=device),
            "mute_input": torch.ones((B,), dtype=torch.bool, device=device)}


def _gen_process(state, ins, params, ctx):
    x = ins[0]
    B, S = x.shape
    rate = ctx.in_formats[0].rate
    bit_per_sample = params["baud"] / rate                    # [B]
    k = torch.arange(S, dtype=torch.float32, device=x.device)[None, :]
    bit_idx_f = state["bit_pos"][:, None] + k * bit_per_sample[:, None]
    # never negative, so the cast truncates as JAX's does
    bit_idx = torch.clamp(bit_idx_f.to(torch.int32), 0, MAX_BITS - 1)
    nbits_f = state["nbits"].to(torch.float32)
    sending = bit_idx_f < nbits_f[:, None]
    bitval = torch.gather(state["bits"], 1, bit_idx.long())
    # 2*pi*freq/rate in float32, as the JAX package computes it
    two_pi = torch.tensor(2 * math.pi, dtype=torch.float32, device=x.device)
    dphase = two_pi * torch.where(bitval > 0.5, MARK_HZ, SPACE_HZ) / rate
    phase = state["phase"][:, None] + torch.cumsum(dphase, dim=1)
    tone = torch.sin(phase) * params["amplitude"][:, None] * sending
    base = torch.where(params["mute_input"][:, None] & sending.any(dim=1, keepdim=True),
                       0.0, x)
    out = torch.clamp(base + tone, -1.0, 1.0)
    new_bit_pos = state["bit_pos"] + S * bit_per_sample
    done = (state["nbits"] > 0) & (new_bit_pos >= nbits_f)
    new_state = {
        "bits": state["bits"],
        "nbits": torch.where(done, 0, state["nbits"]),
        "bit_pos": torch.where(done, 0.0, new_bit_pos),
        "phase": torch.remainder(phase[:, -1], two_pi),
    }
    return new_state, (out,), {"sending_done": done}


register_filter(FilterDef(
    name="baudot_gen", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_gen_init, runtime_params=_gen_params, process=_gen_process,
))


def load_text(state_entry, leg_texts: dict, batch: int):
    """Host helper: upload per-leg bit schedules into a baudot_gen state;
    returns the new state entry, on the old one's device."""
    dev = state_entry["bits"].device
    bits = state_entry["bits"].detach().cpu().numpy().copy()
    nbits = state_entry["nbits"].detach().cpu().numpy().copy()
    pos = state_entry["bit_pos"].detach().cpu().numpy().copy()
    for leg, text in leg_texts.items():
        b = text_to_bits(text)[:MAX_BITS]
        bits[leg, :len(b)] = b
        bits[leg, len(b):] = 1.0
        nbits[leg] = len(b)
        pos[leg] = 0.0
    return {**state_entry, "bits": torch.from_numpy(bits).to(dev),
            "nbits": torch.from_numpy(nbits).to(dev),
            "bit_pos": torch.from_numpy(pos).to(dev)}


# ------------------------------------------------------------- detection
ENV_DECIM = 8      # envelope samples every 8 audio samples (1 ms @8k)
_det_basis: dict = {}


def _basis(rate: int, device):
    """The four Hann-windowed correlation vectors of one 4 ms window (mark
    cos, mark sin, space cos, space sin) as one [W, 4] float32 matrix on
    ``device``, made once per rate and device."""
    key = (rate, device)
    if key not in _det_basis:
        W = ENV_DECIM * 4                              # 4 ms correlation window
        n = torch.arange(W, dtype=torch.float32)
        t = n / rate
        hann = 0.5 - 0.5 * torch.cos(2 * math.pi * n / W)
        cols = [fn(2 * math.pi * f * t) * hann
                for f in (MARK_HZ, SPACE_HZ) for fn in (torch.cos, torch.sin)]
        _det_basis[key] = torch.stack(cols, dim=1).to(device)
    return _det_basis[key]


def _det_init(ctx, device):
    return {"tail": torch.zeros((ctx.batch, ENV_DECIM * 4), dtype=torch.float32,
                                device=device)}


def _det_process(state, ins, params, ctx):
    """Emit per-window mark/space correlation envelopes as events; the host
    BaudotFramer turns them into bits/chars."""
    x = ins[0]
    B, S = x.shape
    xe = torch.cat([state["tail"], x], dim=1)
    W = ENV_DECIM * 4
    n_win = S // ENV_DECIM
    wins = xe.unfold(1, W, ENV_DECIM)[:, :n_win]              # [B, n_win, W]
    corr = wins @ _basis(ctx.in_formats[0].rate, x.device)    # [B, n_win, 4]
    power = corr * corr
    return {"tail": xe[:, -W:]}, (x,), {
        "mark_env": power[..., 0] + power[..., 1],
        "space_env": power[..., 2] + power[..., 3]}


register_filter(FilterDef(
    name="baudot_det", ninputs=1, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_det_init, process=_det_process,
))


class BaudotFramer:
    """Host UART framer over device mark/space envelopes (one per leg)."""

    def __init__(self, rate: int = 8000, baud: float = DEFAULT_BAUD):
        self.samples_per_bit = rate / baud / ENV_DECIM   # envelope steps/bit
        self.env: List[int] = []        # decided mark(1)/space(0) per step
        self.codes: List[int] = []
        self._carrier = False

    def push_envelopes(self, mark: np.ndarray, space: np.ndarray,
                       threshold: float = 1e-3):
        for m, s in zip(mark, space):
            if m < threshold and s < threshold:
                self.env.append(-1)                 # no carrier
            else:
                self.env.append(1 if m >= s else 0)
        self._scan()

    def _scan(self):
        spb = self.samples_per_bit
        need = int(spb * 7) + 2
        while True:
            # find a start bit edge: carrier mark -> space
            found = -1
            for i in range(1, len(self.env) - need):
                if self.env[i] == 0 and self.env[i - 1] == 1:
                    found = i
                    break
            if found < 0:
                if len(self.env) > 4 * need:
                    self.env = self.env[-2 * need:]
                return
            # sample mid-bit positions for start + 5 data
            base = found
            mids = [int(base + spb * (k + 0.5)) for k in range(6)]
            if mids[-1] >= len(self.env):
                return
            samples = [self.env[m] for m in mids]
            if samples[0] != 0:                     # false start
                self.env = self.env[found + 1:]
                continue
            code = 0
            for k in range(5):
                code |= (1 if samples[1 + k] == 1 else 0) << k
            self.codes.append(code)
            self.env = self.env[int(base + spb * 6.5):]

    def text(self) -> str:
        return bits_to_text(self.codes)
