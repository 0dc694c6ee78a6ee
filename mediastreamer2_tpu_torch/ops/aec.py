"""Acoustic echo canceller -- batched two-path partitioned-block FDAF
(port of ``mediastreamer2_tpu/ops/aec.py``).

Each leg runs a multi-delay-block frequency-domain adaptive filter: one
10 ms block per partition, P = ceil(tail / 10 ms) partitions, spectra as
(re, im) f32 pairs, DFTs as FFTs on the card and as matrix products on the
CPU (``ops/rfft.py``). Two filters run side by side: a *shadow* adapts
every tick with an unguarded NLMS step, and is promoted into the *main*
(output) filter only on sustained, near-power-gated improvement; a
diverged shadow is re-seeded from main or, when both are catastrophically
off, zeroed. A spectral residual-echo suppressor follows.

Main taps and far-end history are bf16 [B, P, F]. The shadow taps' storage
is chosen when the state is made, from the JAX package's environment
variables, read as ``_bf16_shadow_on`` reads them (aec.py:100-107):

* bf16 with stochastic rounding (the default): a counter+index integer
  hash (``kernels.sround_bf16``), so the CPU and the card give the same
  bits; the state carries the rounding counter ``srk``;
* f32, with no ``srk`` key, when ``AEC_BF16_SHADOW=0``, ``PALLAS_MDF=1``
  or ``AEC_PALLAS_UPDATE=1``.

The per-tick [B, P, F] work runs in two kernels, both of which update the
taps and history **in place** (the rest of the state is returned as new
tensors):

* ``kernels.mdf_apply`` (Ws bf16 or f32): history shift + both filter
  applies;
* the update, by the path the JAX package takes at each step:

  - bf16 shadow: ``kernels.mdf_update_fused`` in its stochastic-rounding
    mode (the JAX default branch);
  - f32 shadow, megakernel path (``mdf_available(B)``, see
    ``_megakernel_path``): ``kernels.mdf_update``, then the hard reset
    (aec.py:440-446, 543-546);
  - f32 shadow otherwise (the jnp f32 branch or ``AEC_PALLAS_UPDATE=1``,
    aec.py:436-439, 487-496, 508-521, 541-542): ``kernels.mdf_update_fused``
    in its f32 mode.

Two more kernels take chains of PyTorch operations: ``kernels.aec_decide``
(the error signals, the two-path decisions, the output limiter and the
suppressor's leak tracker: every [B, S] time-domain pass and [B] decision
of a tick, once) and ``kernels.suppress_gain`` (the suppressor's gain on
the error spectrum).

``cpos`` (and ``srk``) stay on the device: the host never waits for them.

A tick runs in five profiler spans that cover it (``core/trace.py``):
``ms2.aec/analysis`` (the far block's spectrum and the history powers),
``/apply``, ``/adapt`` (``aec_decide``: the error signals, the two-path
decisions, the output limiter and the leak tracker; then the error
spectrum, the normalisation and the constraint), ``/update`` and
``/suppress`` (the residual-echo suppressor's transforms and gain).

Built for one shard of the legs (``FilterCtx.shard``), the filter reads
the megakernel rule from the whole batch and hands ``mdf_update_fused``
the shard's first index (``offset * P * F``), so the stochastic rounding
hashes each element's index in the whole batch, as JAX's global iota does.

Left out of this port (JAX options that were measured and rejected, or
TPU-only plumbing): ``AEC_CIRC_HIST`` (circular history, aec.py:110) and
``AEC_HALF_UPDATE`` (aec.py:167) -- state init raises when either is set,
rather than computing something else; ``AEC_COND_PROMOTE`` (aec.py:84,
a schedule knob with identical values); the ``F_pad`` lane-padding
plumbing. ``srk`` is an int64 scalar here (uint32 in JAX).

Inputs: pin 0 = near-end (mic), pin 1 = far-end reference (speaker).
Output: echo-cancelled near-end.
"""
from __future__ import annotations

import io
import os

import numpy as np
import torch

from mediastreamer2_tpu_torch.core.filter import FilterDef, register_filter
from mediastreamer2_tpu_torch.core.trace import span
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
# the rest of the decisions' and the leak tracker's thresholds (written
# inline in the JAX package's aec.py:378-411, 601-602)
NF_CREEP = 1.01        # shadow-error floor's creep-up per tick (min statistics)
NF_ACTIVE = 1e-7       # near energy above which the floor tracks
FLOOR_RATIO = 2.0      # shadow within this of its floor counts as converged
MAIN_GATE = 0.8        # re-seed only where main cancels some of the mic
ACTIVE_POW = 1e-5      # near energy that feeds the divergence counter
DIVERGE_RATIO = 1.05   # both filters' errors above the mic -> diverged
BLOWUP_RATIO = 10.0    # the shadow's error this far above the mic -> diverged
DIVERGE_HOLD = 2 * HOLD_TICKS   # divergence evidence that hard-resets
LIMIT_RATIO = 2.0      # output limiter: blend toward the mic above this error
LEAK_GATE = 1.5        # the leak creeps up only while the mic is mostly echo
LEAK_FLOOR = 0.01      # the leak tracker's least value
POW_EPS = 1e-9         # guards the limiter's and the leak's power ratios
DECIDE = kernels.DecideConsts(
    ERR_EWMA, 1 - ERR_EWMA, COPY_RATIO, ERLE_GATE, RESET_RATIO, NF_CREEP, NF_ACTIVE,
    FLOOR_RATIO, MAIN_GATE, ACTIVE_POW, DIVERGE_RATIO, BLOWUP_RATIO, LIMIT_RATIO, LEAK_RISE,
    LEAK_GATE, LEAK_FLOOR, POW_EPS, HOLD_TICKS, DIVERGE_HOLD)
STORE_DTYPE = torch.bfloat16
# the profiler spans of the five stages of a tick, which cover it
_ANALYSIS, _APPLY, _ADAPT, _UPDATE, _SUPPRESS = (
    f"ms2.aec/{stage}" for stage in ("analysis", "apply", "adapt", "update", "suppress"))


def _partitions(ctx):
    tail_ms = int(ctx.params.get("tail_ms", DEFAULT_TAIL_MS))
    return max(1, -(-tail_ms // 10))       # ceil(tail / tick)


def _bf16_shadow_on() -> bool:
    """The JAX package's choice of shadow storage (aec.py:100-107), read at
    state init: the state's Ws dtype then picks the path at every step."""
    env = os.environ.get
    for knob, on in (("AEC_HALF_UPDATE", env("AEC_HALF_UPDATE", "0") != "0"),
                     ("AEC_CIRC_HIST", env("AEC_CIRC_HIST", "0") == "1")):
        if on:
            raise NotImplementedError(
                f"{knob} is not ported: the port runs the full-update, "
                f"shifted-history echo canceller only")
    return (env("AEC_BF16_SHADOW", "1") != "0" and env("PALLAS_MDF", "0") != "1"
            and env("AEC_PALLAS_UPDATE", "0") != "1")


def _megakernel_path(B: int) -> bool:
    """``pallas_kernels.mdf_available(B)`` (:204-212, with ``_mdf_tile``
    :108-110), read at every step as JAX reads it: ``PALLAS_MDF=1``,
    ``PALLAS_DISABLE`` not 1, and B <= 32 or B % 32 == 0. The batch rule is
    the TPU kernel's tiling, which the CUDA kernels do not need; it is
    mirrored so that the same environment and the same B put both packages
    on the same branch."""
    env = os.environ.get
    return (env("PALLAS_MDF", "0") == "1" and env("PALLAS_DISABLE", "0") != "1"
            and (B <= 32 or B % 32 == 0))


def _aec_init(ctx, device):
    B = ctx.batch
    S = ctx.in_formats[0].samples_per_tick
    P = _partitions(ctx)
    F = S + 1
    bf16_shadow = _bf16_shadow_on()
    sdt = STORE_DTYPE if bf16_shadow else torch.float32
    z3 = lambda dt=STORE_DTYPE: torch.zeros((B, P, F), dtype=dt, device=device)
    f = lambda v: torch.full((B,), v, dtype=torch.float32, device=device)
    i = lambda: torch.zeros((B,), dtype=torch.int32, device=device)
    st = {
        "Wm_r": z3(), "Wm_i": z3(),        # main (filtering) taps
        "Ws_r": z3(sdt), "Ws_i": z3(sdt),  # shadow taps (bf16 + stochastic
                                           # rounding, or f32)
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
    }
    if bf16_shadow:
        st["srk"] = torch.zeros((), dtype=torch.int64, device=device)
    return st


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
    bf16_shadow = state["Ws_r"].dtype == STORE_DTYPE
    # a shard takes the unsharded graph's branch (the rule reads the whole
    # batch) and rounds its rows by their index in the whole batch
    megakernel = not bf16_shadow and _megakernel_path(ctx.global_batch)
    lin0 = ctx.shard.offset * P * state["Wm_r"].shape[2] if ctx.shard is not None else 0

    with span(_ANALYSIS):
        far_blk = torch.cat([state["far_prev"], far], dim=1)            # [B, 2S]
        Xr, Xi = rfft(far_blk, two_s)                                   # [B, F]
        # the block leaving the history this tick, read before the in-place
        # shift, in the storage dtype so the telescoping power sum adds and
        # removes identical quantized values
        drop_pow = cabs2(state["Xh_r"][:, -1].float(), state["Xh_i"][:, -1].float())
        inst_q = cabs2(Xr.to(STORE_DTYPE).float(), Xi.to(STORE_DTYPE).float())

    # --- history shift + dual filter apply (in place on Xh) ----------------
    with span(_APPLY):
        Xh_r, Xh_i = state["Xh_r"], state["Xh_i"]
        Ym_r, Ym_i, Ys_r, Ys_i = kernels.mdf_apply(
            state["Wm_r"], state["Wm_i"], state["Ws_r"], state["Ws_i"],
            Xh_r, Xh_i, Xr, Xi)
        y_m = irfft_tail(Ym_r, Ym_i, two_s)
        y_s = irfft_tail(Ys_r, Ys_i, two_s)

    with span(_ADAPT):
        # the error signals, the two-path transfer decisions (per-leg,
        # hysteretic), the output limiter and the suppressor's leak tracker
        suppress = not ctx.params.get("no_suppress")     # build-time bypass
        (e_s, e, y, Em, Es, Dn, Nf, promote_cnt, reseed_cnt, diverge_cnt, leak,
         promote, reseed, hard_reset) = kernels.aec_decide(
            near, y_m, y_s, *(state[k] for k in kernels.DECIDE_ROWS), params["enabled"],
            DECIDE, suppress)
        # --- shadow adaptation inputs --------------------------------------
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

    # --- gradient + NLMS update + transfer copies (in place on Ws, Wm) ------
    with span(_UPDATE):
        if megakernel:
            Ws_r, Ws_i, Wm_r, Wm_i = kernels.mdf_update(
                cpos, state["Ws_r"], state["Ws_i"], state["Wm_r"], state["Wm_i"],
                Xh_r, Xh_i, Er, Ei, inv_norm, gc_r, gc_i, mu,
                promote.to(torch.float32), reseed.to(torch.float32))
            h3 = hard_reset[:, None, None]
            Ws_r.masked_fill_(h3, 0.0)
            Ws_i.masked_fill_(h3, 0.0)
        else:
            Ws_r, Ws_i, Wm_r, Wm_i = kernels.mdf_update_fused(
                cpos, state["Ws_r"], state["Ws_i"], state["Wm_r"], state["Wm_i"],
                Xh_r, Xh_i, Er, Ei, inv_norm, gc_r, gc_i, mu, promote, reseed,
                hard_reset, state.get("srk"), lin0)

    with span(_SUPPRESS):
        new_state = {"Wm_r": Wm_r, "Wm_i": Wm_i, "Ws_r": Ws_r, "Ws_i": Ws_i,
                     "Xh_r": Xh_r, "Xh_i": Xh_i, "far_prev": far, "Hp": Hp,
                     "Em": Em, "Es": Es, "Dn": Dn, "Nf": Nf, "leak": leak,
                     "promote_cnt": promote_cnt, "reseed_cnt": reseed_cnt,
                     "diverge_cnt": diverge_cnt,
                     "cpos": torch.remainder(cpos + 1, P).to(torch.int32)}
        if bf16_shadow:
            new_state["srk"] = state["srk"] + 1
        if not suppress:
            return new_state, (e,), {}
        # --- residual echo suppression --------------------------------------
        # over-subtract only the estimated residual (leak * |Y|)
        Ehr, Ehi = rfft(e, S)
        Yhr, Yhi = rfft(y, S)
        # gain = clamp((|E| - beta sqrt(leak) |Y|) / |E|, floor, 1) on E
        e_sup = irfft(*kernels.suppress_gain(Ehr, Ehi, Yhr, Yhi, leak, SUPPRESS_BETA,
                                             SUPPRESS_FLOOR), S)
        out = torch.where((params["suppress"] & params["enabled"])[:, None], e_sup, e)
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


def set_state_blob(blob: bytes, device):
    """EC state from a ``get_state_blob`` blob (from either package), on
    ``device`` (``"cpu"`` or a CUDA device)."""
    data = np.load(io.BytesIO(blob))
    bf16 = set(data["__bf16__"].tolist()) if "__bf16__" in data.files else set()
    return {k: (torch.from_numpy(data[k]).to(device=device, dtype=torch.bfloat16)
                if k in bf16 else torch.from_numpy(data[k]).to(device))
            for k in data.files if k != "__bf16__"}
