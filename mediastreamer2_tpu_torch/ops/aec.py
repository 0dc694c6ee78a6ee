"""Acoustic echo canceller -- batched two-path partitioned-block FDAF
(port of ``mediastreamer2_tpu/ops/aec.py``, default path).

Each leg runs a multi-delay-block frequency-domain adaptive filter: one
10 ms block per partition, P = ceil(tail / 10 ms) partitions, spectra as
(re, im) f32 pairs and DFTs as matrix products (``ops/rfft.py``). Two filters
run side by side: a *shadow* adapts every tick with an unguarded NLMS step,
and is promoted into the *main* (output) filter only on sustained,
near-power-gated improvement; a diverged shadow is re-seeded from main or,
when both are catastrophically off, zeroed. A spectral residual-echo
suppressor follows.

Storage, as the JAX default: main taps, shadow taps and far-end history are
bf16 [B, P, F]; the shadow is stochastically rounded with a counter+index
integer hash (``kernels.sround_bf16``), so the CPU and the card give the
same bits. The per-tick [B, P, F] work runs in two kernels:

* ``kernels.mdf_apply``: history shift + both filter applies;
* ``kernels.mdf_update_fused``: NLMS update, the round-robin causality
  constraint and the promote / reseed / hard-reset transfers.

Both update the state's taps and history **in place**; the rest of the
state is returned as new tensors. The partition index ``cpos`` and the
rounding counter ``srk`` stay on the device: the host never waits for them.

Left out of this port (JAX options that were measured and rejected, or
TPU-only plumbing): ``AEC_CIRC_HIST`` (circular history, aec.py:110),
``AEC_HALF_UPDATE`` (aec.py:167), ``AEC_COND_PROMOTE`` (aec.py:84), the
``F_pad`` lane-padding plumbing, the ``PALLAS_MDF`` and
``AEC_PALLAS_UPDATE`` knobs, and the f32-shadow state mode
(``AEC_BF16_SHADOW=0``). ``srk`` is an int64 scalar here (uint32 in JAX).

Inputs: pin 0 = near-end (mic), pin 1 = far-end reference (speaker).
Output: echo-cancelled near-end.
"""
from __future__ import annotations

import io

import numpy as np
import torch

from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter
from mediastreamer2_tpu_torch.ops import kernels
from mediastreamer2_tpu_torch.ops.rfft import (rfft, irfft, rfft_tail, irfft_tail,
                                               apply_constraint, cmul_conj, cabs2)

DEFAULT_TAIL_MS = 80
MU = 0.6               # shadow NLMS step
ERR_EWMA = 0.6         # error-energy smoothing for transfer logic
COPY_RATIO = 0.4       # shadow must (sustainably) halve the error -> promote
ERLE_GATE = 0.2        # ...and cancel >=6 dB of the mic signal
RESET_RATIO = 1.5      # shadow (sustainably) worse than main -> re-seed
HOLD_TICKS = 8         # hysteresis: condition must hold 50 ms
SUPPRESS_BETA = 2.5    # over-subtraction factor (on the *residual* estimate)
SUPPRESS_FLOOR = 0.15  # spectral floor
LEAK_RISE = 1.01       # min-statistics leak tracker creep-up per tick
STORE_DTYPE = torch.bfloat16


def _partitions(ctx):
    tail_ms = int(ctx.params.get("tail_ms", DEFAULT_TAIL_MS))
    return max(1, -(-tail_ms // 10))       # ceil(tail / tick)


def _aec_init(ctx, device):
    B = ctx.batch
    S = ctx.in_formats[0].samples_per_tick
    P = _partitions(ctx)
    F = S + 1
    z3 = lambda: torch.zeros((B, P, F), dtype=STORE_DTYPE, device=device)
    f = lambda v: torch.full((B,), v, dtype=torch.float32, device=device)
    i = lambda: torch.zeros((B,), dtype=torch.int32, device=device)
    return {
        "Wm_r": z3(), "Wm_i": z3(),        # main (filtering) taps
        "Ws_r": z3(), "Ws_i": z3(),        # shadow taps (stochastic rounding)
        "Xh_r": z3(), "Xh_i": z3(),        # far-end block spectra history
        "far_prev": torch.zeros((B, S), dtype=torch.float32, device=device),
        "Hp": torch.zeros((B, F), dtype=torch.float32, device=device),
        "Em": f(1e-6),                     # smoothed main error
        "Es": f(1e-6),                     # smoothed shadow error
        "Dn": f(1e-6),                     # smoothed near energy
        "promote_cnt": i(),
        "reseed_cnt": i(),
        "diverge_cnt": i(),
        "Nf": f(1.0),                      # shadow-error floor (min stats)
        "leak": f(1.0),
        "cpos": torch.zeros((), dtype=torch.int32, device=device),
        "srk": torch.zeros((), dtype=torch.int64, device=device),
    }


def _aec_params(ctx, device):
    B = ctx.batch
    on = lambda: torch.ones((B,), dtype=torch.bool, device=device)
    return {
        "enabled": on(),
        "adapt": on(),
        "mu": torch.full((B,), MU, dtype=torch.float32, device=device),
        "suppress": on(),
    }


def _aec_process(state, ins, params, ctx):
    near, far = ins
    B, S = near.shape
    two_s = 2 * S
    P = state["Wm_r"].shape[1]

    far_blk = torch.cat([state["far_prev"], far], dim=1)            # [B, 2S]
    Xr, Xi = rfft(far_blk, two_s)                                   # [B, F]
    # the block leaving the history this tick, read before the in-place
    # shift, in the storage dtype so the telescoping power sum adds and
    # removes identical quantized values
    drop_pow = cabs2(state["Xh_r"][:, -1].float(), state["Xh_i"][:, -1].float())
    inst_q = cabs2(Xr.to(STORE_DTYPE).float(), Xi.to(STORE_DTYPE).float())

    # --- history shift + dual filter apply (in place on Xh) ----------------
    Xh_r, Xh_i = state["Xh_r"], state["Xh_i"]
    Ym_r, Ym_i, Ys_r, Ys_i = kernels.mdf_apply(
        state["Wm_r"], state["Wm_i"], state["Ws_r"], state["Ws_i"],
        Xh_r, Xh_i, Xr, Xi)
    y_m = irfft_tail(Ym_r, Ym_i, two_s)
    y_s = irfft_tail(Ys_r, Ys_i, two_s)
    e_m = near - y_m
    e_s = near - y_s

    # --- shadow adaptation inputs ------------------------------------------
    Er, Ei = rfft_tail(e_s, two_s)
    # exact MDF-NLMS normalization by the running per-bin history power
    Hp = torch.clamp(state["Hp"] + inst_q - drop_pow, min=0.0)
    # fade out bins where the far end carries no energy (continuous ramp)
    thr = 1e-3 * Hp.mean(dim=1, keepdim=True) + 1e-12
    bin_w = torch.clamp(Hp / thr - 1.0, 0.0, 1.0)
    inv_norm = bin_w / (Hp + 1e-5)
    mu = params["mu"] * params["adapt"].to(torch.float32)
    # causality constraint on ONE partition per tick, round-robin
    cpos = state["cpos"]
    cidx = cpos.reshape(1).long()
    hp_r = torch.index_select(Xh_r, 1, cidx)[:, 0].float()
    hp_i = torch.index_select(Xh_i, 1, cidx)[:, 0].float()
    gp_r, gp_i = cmul_conj(hp_r, hp_i, Er, Ei)
    gc_r, gc_i = apply_constraint(gp_r * inv_norm, gp_i * inv_norm, two_s)

    # --- two-path transfer decisions (per-leg, hysteretic) ------------------
    Em = ERR_EWMA * state["Em"] + (1 - ERR_EWMA) * (e_m * e_m).mean(dim=1)
    Es = ERR_EWMA * state["Es"] + (1 - ERR_EWMA) * (e_s * e_s).mean(dim=1)
    Dn = ERR_EWMA * state["Dn"] + (1 - ERR_EWMA) * (near * near).mean(dim=1)
    # shadow-error floor via min statistics
    Nf = torch.where(Dn > 1e-7, torch.minimum(state["Nf"] * 1.01, Es), state["Nf"])
    at_floor = Es < 2.0 * Nf
    better = (Es < COPY_RATIO * Em) & ((Es < ERLE_GATE * Dn) | at_floor)
    worse = (Es > RESET_RATIO * Em) & (Em < 0.8 * Dn)
    zero = torch.zeros_like(state["promote_cnt"])
    promote_cnt = torch.where(better, state["promote_cnt"] + 1, zero)
    reseed_cnt = torch.where(worse, state["reseed_cnt"] + 1, zero)
    promote = promote_cnt >= HOLD_TICKS
    reseed = reseed_cnt >= HOLD_TICKS
    promote_cnt = torch.where(promote, zero, promote_cnt)
    reseed_cnt = torch.where(reseed, zero, reseed_cnt)
    # catastrophic-divergence insurance (leaky evidence counter)
    active = Dn > 1e-5
    diverged = ((torch.minimum(Em, Es) > 1.05 * Dn) | (Es > 10.0 * Dn)) & active
    diverge_cnt = torch.where(
        diverged, state["diverge_cnt"] + 1,
        torch.where(active, torch.clamp(state["diverge_cnt"] - 1, min=0),
                    state["diverge_cnt"]))
    hard_reset = diverge_cnt >= 2 * HOLD_TICKS
    diverge_cnt = torch.where(hard_reset, zero, diverge_cnt)
    # never promote taps declared catastrophically diverged this tick
    promote = promote & ~hard_reset

    # --- gradient + NLMS update + transfer copies (in place on Ws, Wm) ------
    Ws_r, Ws_i, Wm_r, Wm_i = kernels.mdf_update_fused(
        cpos, state["Ws_r"], state["Ws_i"], state["Wm_r"], state["Wm_i"],
        Xh_r, Xh_i, Er, Ei, inv_norm, gc_r, gc_i, mu, promote, reseed,
        hard_reset, state["srk"])
    Em = torch.where(promote, Es, Em)
    Es = torch.where(reseed, Em, Es)
    Es = torch.where(hard_reset, Dn, Es)

    e = torch.where(promote[:, None], e_s, e_m)
    y = torch.where(promote[:, None], y_s, y_m)
    # per-tick output limiter: blend back toward the mic (continuously) if
    # the selected filter makes this block worse than the raw mic
    blk_near = (near * near).mean(dim=1)
    blk_err = (e * e).mean(dim=1)
    w_bad = torch.clamp(blk_err / (2.0 * blk_near + 1e-9) - 1.0, 0.0, 1.0)[:, None]
    e = (1.0 - w_bad) * e + w_bad * near
    y = (1.0 - w_bad) * y
    e = torch.where(params["enabled"][:, None], e, near)

    new_state = {"Wm_r": Wm_r, "Wm_i": Wm_i, "Ws_r": Ws_r, "Ws_i": Ws_i,
                 "Xh_r": Xh_r, "Xh_i": Xh_i, "far_prev": far, "Hp": Hp,
                 "Em": Em, "Es": Es, "Dn": Dn, "Nf": Nf,
                 "leak": state["leak"],
                 "promote_cnt": promote_cnt, "reseed_cnt": reseed_cnt,
                 "diverge_cnt": diverge_cnt,
                 "cpos": torch.remainder(cpos + 1, P).to(torch.int32),
                 "srk": state["srk"] + 1}
    # --- residual echo suppression ------------------------------------------
    if ctx.params.get("no_suppress"):
        # build-time suppressor bypass (static)
        return new_state, (e,), {}

    # over-subtract only the estimated residual (leak * |Y|); `leak` is the
    # residual/echo power ratio, tracked as a slow minimum
    Ey = (y * y).mean(dim=1)
    inst_leak = (e * e).mean(dim=1) / (Ey + 1e-9)
    rise = torch.where(Dn < 1.5 * Ey, LEAK_RISE, 1.0)
    leak = torch.clamp(torch.minimum(state["leak"] * rise, inst_leak), 0.01, 1.0)
    Ehr, Ehi = rfft(e, S)
    mag_e = torch.sqrt(cabs2(Ehr, Ehi) + 1e-18)
    Yhr, Yhi = rfft(y, S)
    mag_y = torch.sqrt(cabs2(Yhr, Yhi) + 1e-18)
    resid_mag = torch.sqrt(leak)[:, None] * mag_y
    gain = torch.clamp((mag_e - SUPPRESS_BETA * resid_mag) / (mag_e + 1e-9),
                       SUPPRESS_FLOOR, 1.0)
    e_sup = irfft(Ehr * gain, Ehi * gain, S)
    out = torch.where((params["suppress"] & params["enabled"])[:, None], e_sup, e)
    new_state["leak"] = leak
    return new_state, (out,), {}


register_filter(FilterDef(
    name="echo_canceller", ninputs=2, noutputs=1,
    out_formats=lambda ctx: (ctx.in_formats[0],),
    init=_aec_init, runtime_params=_aec_params, process=_aec_process,
    interfaces=("echo_canceller",),
))


def get_state_blob(state_entry) -> bytes:
    """Serialize EC state for warm restart (npz, the JAX package's format):
    bf16 tensors travel as float32, named in ``__bf16__``."""
    buf = io.BytesIO()
    arrays = {}
    bf16_keys = []
    for k, v in state_entry.items():
        if v.dtype == torch.bfloat16:
            bf16_keys.append(k)
            v = v.float()
        arrays[k] = v.detach().cpu().numpy()
    arrays["__bf16__"] = np.array(bf16_keys)
    np.savez(buf, **arrays)
    return buf.getvalue()


def set_state_blob(blob: bytes, device="cpu"):
    data = np.load(io.BytesIO(blob))
    bf16 = set(data["__bf16__"].tolist()) if "__bf16__" in data.files else set()
    return {k: (torch.from_numpy(data[k]).to(device=device, dtype=torch.bfloat16)
                if k in bf16 else torch.from_numpy(data[k]).to(device))
            for k in data.files if k != "__bf16__"}
