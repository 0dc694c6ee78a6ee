#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mediastreamer2_tpu_torch) on one
NVIDIA GPU: builds its kernels and its native RTP edge from source, checks
each kernel against its plain PyTorch version on the card, drives the
flagship conference leg, the end-to-end G.711 leg over localhost UDP and
the session layer, and compares the port on the card with the port on
the CPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, g++ and nvidia-smi; imports nothing of JAX.
Phases, in order (any failure raises and the script exits non-zero):

1. card, versions, build times (nvcc for the kernels and g++ for the
   edge, started together);
2. each kernel against its plain version, at the flagship's shapes
   (fused_volume; mdf_apply with bf16 and with f32 shadow taps;
   mdf_update at cpos 0, 3, 7; mdf_update_fused, f32 and bf16 shadow)
   and at the session's (B = 1,024, S = 80, F = 81: the three kernels of
   its path), with each one's device time per launch (the stream spins
   while the host enqueues, then one event pair around 50 launches, over
   input sets that spill the L2), its bound (bytes over 3.35 TB/s or
   operations over 67 TFLOP/s, the larger) and its share of the bound;
3. the flagship at 4,096 legs (1,024 four-party conferences) for 100
   ticks of echo-coupled input: fused_volume, mdf_apply and
   mdf_update_fused launched once per tick and mdf_update never, all
   outputs finite, the AEC's shadow filter converged (Es < 0.5 * Dn) on
   >= 90% of legs; ms/tick;
4. the flagship on the CPU (plain versions) against the card (kernels) on
   the cross-backend fixture (256 legs, 100 ticks), held to the bar of
   tools/tpu_correctness.py: audio_diff >= 0.999 on legs 0, 37, 74, ...
   (the all-legs minimum is printed too), rms error <= 5e-3, and per-leg
   energy gap <= 1.5 dB;
5. the e2e leg (models/e2e_bench.py) in the AEC's megakernel mode
   (PALLAS_MDF=1): 1,024 legs paced over localhost UDP for 300 measured
   ticks inside paused_gc, with mdf_apply, mdf_update and fused_volume
   launched once per tick and mdf_update_fused never, finite graph
   outputs and state, loss < 0.02 and fidelity >= 0.9; then 4,096 legs
   unpaced for 100 ticks, printed with no bar;
6. the e2e graph without the network in megakernel mode, the CPU against
   the card, 256 legs x 100 ticks fed the same mu-law codes, held to the
   bar of phase 4;
7. the session layer (AudioStreamBatch, Ticker, AudioConferenceControl):
   echo-cancelling (AEC + AGC) mu-law clients against a conference
   server, legs 4k..4k+3 in conference k, leg 4k talking. 7a: 1,024 +
   1,024 legs over the batch edge, 200 alternating do_ticks: fused_volume
   3 (the clients' two volumes, the server's receive volume: a conference
   stream has no send volume), mdf_apply 1 and mdf_update_fused 1
   launches per tick pair and mdf_update none, finite outputs and state, each leg's edge recv >=
   ticks/2, active_talkers names each talker and no listener; 7b: 64 +
   64 legs over LoopbackPair, each ticker start()ed paced on its own
   thread (late ticks and load printed, no bar); 7a and 7b hold each
   sampled listener's recording to audio_diff > 0.85 against its
   talker's speech as sent (the talker's codes on the wire; the talker's
   own AGC shapes it) and > 0.7 against its mic, and the talker's own
   recording to < 5% of a listener's energy (mix-minus); 7c: 8 + 8 legs
   on the CPU against the card, the listeners' recordings held to the
   bar of phase 4.

The last two lines of standard output are the kernels' JSON and the
result's JSON; the card's name and power limit come before them.
"""
import contextlib
import json
import math
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "mediastreamer2_tpu_torch/csrc/ms2_kernels.cu"
REPLACES = {  # the TPU kernel each CUDA kernel replaces
    "fused_volume": "mediastreamer2_tpu/ops/pallas_kernels.py:56",
    "mdf_apply": "mediastreamer2_tpu/ops/pallas_kernels.py:133",
    "mdf_update": "mediastreamer2_tpu/ops/pallas_kernels.py:178",
    "mdf_update_fused": "mediastreamer2_tpu/ops/pallas_kernels.py:278",
}
LEGS = 4096
TICKS = 100
CROSS_LEGS = 256
CROSS_TICKS = 100
E2E_LEGS = 1024
E2E_TICKS = 300
E2E_BIG_LEGS = 4096
E2E_BIG_TICKS = 100
SESSION_LEGS = 1024           # phase 7a: clients and server, each
SESSION_TICKS = 200
PACED_LEGS = 64               # phase 7b
PACED_TICKS = 300
CROSS_SESSION_LEGS = 8        # phase 7c
CROSS_SESSION_TICKS = 150
P, F, S = 8, 481, 480         # the flagship's AEC at 48 kHz
SP, SF, S8 = 8, 81, 80        # the session's AEC at 8 kHz


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def device_ms(fn, n: int = 50) -> float:
    """Device time of one call of ``fn(i)``, without the host's wrapper
    cost: after 3 warm-up calls, the host's enqueue time for ``n`` calls is
    measured; then the stream spins (``torch.cuda._sleep``) for longer than
    that before one event pair around ``n`` calls, so the device runs them
    back to back; the pair's time over ``n``. ``i`` counts the calls, for
    callers that rotate through input sets."""
    for i in range(3):
        fn(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        fn(i)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * host_s * 2.0e9) + 1_000_000)   # >= 2x at <= 2 GHz
    a.record()
    for i in range(n):
        fn(i)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / n


# -- bounds: the least time the card could take for a kernel's work -----------
# Each input byte read once, each output byte written once; operations
# over the float32 rate outside the tensor cores (none of the four has a
# matrix product). H100 SXM at 700 W: 3.35 TB/s, 67 TFLOP/s float32.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
L2_BYTES = 50e6


def fused_volume_cost(B, S):
    """(bytes, operations): x read, y written ([B, S] f32), four [B] f32
    in, energy and mean out; ~10 operations a sample."""
    return 4 * B * S * 2 + 4 * B * (4 + 2), 10 * B * S


def mdf_apply_cost(B, P, F, ws_bytes):
    """Wm (bf16) and Ws read over P partitions; the history Xh (bf16)
    shifted in place: partitions 0..P-2 read (the last one drops out, the
    new block takes partition 0), all P written; the new block Xr/Xi in and
    Ym/Ys out ([B, F] f32); two complex multiply-adds per (leg, partition,
    bin) and filter."""
    return (B * F * (P * (2 * 2 + 2 * ws_bytes) + (P - 1) * 2 * 2 + P * 2 * 2)
            + 4 * B * F * (2 + 4),
            16 * B * P * F)


def mdf_update_cost(B, P, F):
    """Ws (f32) and Wm (bf16) read and written, Xh read; Er, Ei,
    inv_norm, gc_r, gc_i in ([B, F] f32); mu, promote, reseed ([B] f32)
    and cpos in."""
    return (B * P * F * (2 * 4 * 2 + 2 * 2 * 2 + 2 * 2) + 4 * B * F * 5 + 4 * B * 3 + 4,
            28 * B * P * F)


def mdf_update_fused_cost(B, P, F, ws_bytes, wm_read_legs=0, wm_write_legs=0):
    """Ws read and written, Xh read; Wm read only on the legs that reseed
    (and are not hard-reset) and written only on the legs promoted, as the
    data of the call needs; the [B, F] f32 operands and the [B] flags, mu,
    cpos and srk in."""
    return (B * P * F * (2 * ws_bytes * 2 + 2 * 2) + P * F * 2 * 2 * (wm_read_legs + wm_write_legs)
            + 4 * B * F * 5 + B * (4 + 3) + 4 + 8,
            40 * B * P * F)


def bound(cost):
    """(bound ms, what bounds it) of a (bytes, operations) pair."""
    nbytes, ops = cost
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def rotation(nbytes) -> int:
    """Input sets to cycle through so that back-to-back launches read
    device memory and not the 50 MB L2 (a real tick runs other work
    between two launches): enough sets for 2.5x the L2."""
    return max(1, min(64, math.ceil(2.5 * L2_BYTES / nbytes)))


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _require_equal(name, got, want):
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs err {_max_err(got, want)})")


def _timed(entry, cost, make_args, kernel_fn, plain_fn):
    """Device times of the kernel and its plain version on ``rotation``
    fresh input sets from ``make_args()``, beside the bound."""
    sets = [make_args() for _ in range(rotation(cost[0]))]
    entry["ms"] = device_ms(lambda i: kernel_fn(*sets[i % len(sets)]))
    entry["plain_ms"] = device_ms(lambda i: plain_fn(*sets[i % len(sets)]), n=10)
    entry["bound_ms"], entry["bound_by"] = bound(cost)
    entry["bytes"] = cost[0]
    return entry


def kernel_checks(kernels, dev, card, B, S, P, F, full=True):
    """Phase 2 at one set of shapes: each kernel against its plain version
    on the card, timed (device time, ``device_ms``) beside its bound.
    ``full`` adds the f32-shadow modes and mdf_update (the flagship's and
    the e2e leg's); the session's path runs the bf16-shadow kernels only."""
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape, s=1.0: s * torch.randn(shape, generator=g, device=dev)
    legs = lambda: torch.rand((B,), generator=g, device=dev) < 0.3
    results = {}

    # fused_volume: [B, S] f32; sums run in another order (rtol 1e-5)
    def vol_args():
        return (rnd(B, S, s=0.5), rnd(B).abs() + 0.1, rnd(B).abs() + 0.1, rnd(B, s=0.05),
                (torch.rand((B,), generator=g, device=dev) < 0.5).float())
    vargs = vol_args()
    got = kernels.fused_volume(*vargs)
    want = kernels.fused_volume_reference(*vargs)
    err = 0.0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        err = max(err, _max_err(a, b))
    results["fused_volume"] = _timed(
        {"max_abs_err": err, "tolerance": "rtol 1e-5, atol 1e-6"}, fused_volume_cost(B, S),
        vol_args, kernels.fused_volume, kernels.fused_volume_reference)

    # mdf_apply: [B, P, F], bit-exact (no FMA contraction); shadow taps bf16
    # (the default) and f32 (the megakernel and f32-shadow modes)
    modes = [("mdf_apply (f32 Ws)", torch.float32)] if full else []
    for name, sdt in modes + [("mdf_apply", torch.bfloat16)]:
        def apply_args():
            return ([rnd(B, P, F, s=0.1).to(torch.bfloat16) for _ in range(2)]
                    + [rnd(B, P, F, s=0.1).to(sdt) for _ in range(2)]
                    + [rnd(B, P, F).to(torch.bfloat16) for _ in range(2)]
                    + [rnd(B, F) for _ in range(2)])
        args = apply_args()
        a_k = [t.clone() for t in args]
        got = kernels.mdf_apply(*a_k)
        want = kernels.mdf_apply_reference(*args)
        for i, (a, b) in enumerate(zip(got + tuple(a_k[4:6]), want + tuple(args[4:6]))):
            _require_equal(f"{name} output {i}", a, b)
        results[name] = _timed(
            {"max_abs_err": 0.0, "tolerance": "bit-exact"},
            mdf_apply_cost(B, P, F, torch.finfo(sdt).bits // 8), apply_args,
            kernels.mdf_apply, kernels.mdf_apply_reference)

    # mdf_update_fused: the f32 shadow mode at cpos 3, then the bf16 shadow
    # (default, timed) at cpos 0, 3, 7; 30% of legs promoted, reseeded or
    # hard-reset
    hist = [rnd(B, P, F).to(torch.bfloat16) for _ in range(2)]
    spec = [rnd(B, F, s=0.3), rnd(B, F, s=0.3), rnd(B, F).abs(),
            rnd(B, F, s=0.05), rnd(B, F, s=0.05)]
    mu = rnd(B).abs() * 0.6
    flags = [legs(), legs(), legs()]
    flags[0] &= ~flags[2]
    srk = torch.tensor(123456789, dtype=torch.int64, device=dev)
    cases = ((3, torch.float32),) if full else ()
    for cpos_v, sdt in cases + ((0, torch.bfloat16), (3, torch.bfloat16), (7, torch.bfloat16)):
        cpos = torch.tensor(cpos_v, dtype=torch.int32, device=dev)
        ws = [rnd(B, P, F, s=0.1).to(torch.bfloat16).to(sdt) for _ in range(2)]
        wm = [rnd(B, P, F, s=0.1).to(torch.bfloat16) for _ in range(2)]
        st_k = [t.clone() for t in ws + wm]
        st_p = [t.clone() for t in ws + wm]
        kernels.mdf_update_fused(cpos, *st_k, *hist, *spec, mu, *flags, srk)
        kernels.mdf_update_fused_reference(cpos, *st_p, *hist, *spec, mu, *flags, srk)
        for name, a, b in zip(("Ws_r", "Ws_i", "Wm_r", "Wm_i"), st_k, st_p):
            _require_equal(f"mdf_update_fused {name} cpos={cpos_v} {sdt}", a, b)

    def fused_args():
        return ([rnd(B, P, F, s=0.1).to(torch.bfloat16) for _ in range(6)]
                + [t.clone() for t in spec])
    wm_read = int((flags[1] & ~flags[2]).sum())
    results["mdf_update_fused"] = _timed(
        {"max_abs_err": 0.0, "tolerance": "bit-exact"},
        mdf_update_fused_cost(B, P, F, 2, wm_read, int(flags[0].sum())), fused_args,
        lambda *a: kernels.mdf_update_fused(cpos, *a, mu, *flags, srk),
        lambda *a: kernels.mdf_update_fused_reference(cpos, *a, mu, *flags, srk))
    if full:
        # mdf_update: f32 Ws, bf16 Wm [B, P, F], bit-exact at cpos 0, 3, 7;
        # promote and reseed 0/1 floats on 30% of legs each, never both
        pr_f, rs_f = flags[0].float(), (flags[1] & ~flags[0]).float()
        for cpos_v in (0, 3, 7):
            cpos = torch.tensor(cpos_v, dtype=torch.int32, device=dev)
            ws = [rnd(B, P, F, s=0.1) for _ in range(2)]
            wm = [rnd(B, P, F, s=0.1).to(torch.bfloat16) for _ in range(2)]
            st_k = [t.clone() for t in ws + wm]
            st_p = [t.clone() for t in ws + wm]
            kernels.mdf_update(cpos, *st_k, *hist, *spec, mu, pr_f, rs_f)
            kernels.mdf_update_reference(cpos, *st_p, *hist, *spec, mu, pr_f, rs_f)
            for name, a, b in zip(("Ws_r", "Ws_i", "Wm_r", "Wm_i"), st_k, st_p):
                _require_equal(f"mdf_update {name} cpos={cpos_v}", a, b)

        def update_args():
            return ([rnd(B, P, F, s=0.1) for _ in range(2)]
                    + [rnd(B, P, F, s=0.1).to(torch.bfloat16) for _ in range(4)]
                    + [t.clone() for t in spec])
        results["mdf_update"] = _timed(
            {"max_abs_err": 0.0, "tolerance": "bit-exact"}, mdf_update_cost(B, P, F),
            update_args, lambda *a: kernels.mdf_update(cpos, *a, mu, pr_f, rs_f),
            lambda *a: kernels.mdf_update_reference(cpos, *a, mu, pr_f, rs_f))
    for name, r in results.items():
        print(f"kernel {name} [B={B} S={S} P={P} F={F}]: matches plain ({r['tolerance']}, "
              f"max abs err {r['max_abs_err']}); device {r['ms']:.4f} ms per launch, bound "
              f"{r['bound_ms']:.4f} ms ({r['bytes'] / 1e6:.1f} MB, {r['bound_by']}), "
              f"{100 * r['bound_ms'] / r['ms']:.0f}% of bound; plain {r['plain_ms']:.4f} ms "
              f"[{card}]", flush=True)
    return results


def _device_ticks(a: np.ndarray, ticks: int, dev) -> torch.Tensor:
    """[legs, ticks*S] numpy -> [ticks, legs, S] contiguous on ``dev``."""
    legs = a.shape[0]
    return torch.from_numpy(a).to(dev).view(legs, ticks, S).permute(1, 0, 2).contiguous()


def run_flagship(legs, ticks, dev, mic, far):
    """Drive the flagship graph for ``ticks`` ticks. Returns (state,
    output [legs, ticks*samples] on ``dev``, all-finite flag, host seconds
    per tick over ticks 1.. (the first tick, which pays one-time set-up,
    is left out))."""
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.models.flagship import build_flagship
    cg, params = build_flagship(Factory(), legs, dev)
    state = cg.init_state(dev)
    mic_t, far_t = _device_ticks(mic, ticks, dev), _device_ticks(far, ticks, dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    outs = []
    for t in range(ticks):
        if t == 1:
            sync()
            t0 = time.perf_counter()
        state, out, _ = cg.step(state, params, {"mic": mic_t[t], "spk_ref": far_t[t]})
        finite &= torch.isfinite(out["out"]).all()
        outs.append(out["out"])
    sync()
    per_tick = (time.perf_counter() - t0) / (ticks - 1)
    return state, torch.cat(outs, dim=1), bool(finite), per_tick


@contextlib.contextmanager
def environ(**env):
    """Set environment variables for the block, restore them after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _require_counts(path, launches, want):
    if launches != want:
        raise AssertionError(f"{path}: kernel launches {launches}, expected {want}")


def run_e2e(kernels, dev, card, legs, ticks, paced):
    """Phase 5: the e2e bench in megakernel mode; returns (result, the
    launches of its run, the ticks it dispatched)."""
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.core.rtgc import paused_gc
    from mediastreamer2_tpu_torch.models.e2e_bench import (WARMUP_TICKS,
                                                           E2EConferenceBench)
    b = E2EConferenceBench(Factory(), legs, dev)
    try:
        b.warm()                    # first launches outside the counted run
        t0 = b._t
        kernels.reset_launch_counts()
        with paused_gc():
            res = b.run(ticks + WARMUP_TICKS, paced=paced, trace=True)
        launches = kernels.launch_counts()
        dispatched = b._t - t0
        ws_dtype = str(b.state["ec"]["Ws_r"].dtype).replace("torch.", "")
        state_finite = all(bool(torch.isfinite(v).all()) for entry in b.state.values()
                           for v in entry.values() if v.is_floating_point())
    finally:
        b.close()
    ph = " ".join(f"{k} {v:.3f}" for k, v in res.phases_ms.items() if not k.endswith("_max"))
    print(f"e2e {'paced' if paced else 'unpaced'}: {legs} legs x {res.ticks} measured ticks "
          f"({dispatched} dispatched), K=1 D=2, megakernel AEC (Ws {ws_dtype}), "
          f"{res.ms_per_tick:.3f} ms/tick, late ticks {res.late_ticks}, loss "
          f"{res.loss_rate:.5f}, fidelity {res.fidelity:.5f}, mouth-to-ear "
          f"{res.mouth_to_ear_ms:.0f} ms, edge threads {b.edge_threads}, UDP GSO {b.gso}, "
          f"out finite {res.out_finite}, state finite {state_finite}, launches {launches}; "
          f"host ms/tick by phase: {ph} [{card}]", flush=True)
    want = {"fused_volume": dispatched, "mdf_apply": dispatched,
            "mdf_update": dispatched, "mdf_update_fused": 0}
    _require_counts(f"e2e {legs} legs", launches, want)
    if ws_dtype != "float32":
        raise AssertionError(f"megakernel mode needs an f32 shadow, got {ws_dtype}")
    if not (res.out_finite and state_finite):
        raise AssertionError("e2e graph output or state holds non-finite values")
    return res, launches, dispatched


def e2e_cross(dev, legs, ticks):
    """Phase 6: the e2e graph on the CPU and on the card, megakernel mode,
    fed the same mu-law codes. Returns (outputs cpu, outputs card, both
    finite, cpu ms/tick)."""
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.models.e2e_bench import (build_e2e_graph, e2e_tick,
                                                           echo_coupled_codes)
    codes, mic = echo_coupled_codes(legs, ticks, seed=9)
    outs, finite, cpu_tick = [], True, 0.0
    for d in (torch.device("cpu"), dev):
        cg, params = build_e2e_graph(Factory(), legs, d)
        state = cg.init_state(d)
        codes_d, mic_d = torch.from_numpy(codes).to(d), torch.from_numpy(mic).to(d)
        out = []
        t0 = time.perf_counter()
        for t in range(ticks):
            state, _, _, o = e2e_tick(cg, state, params, codes_d[:, t * 80:(t + 1) * 80],
                                      mic_d[:, t * S:(t + 1) * S].contiguous())
            out.append(o)
        out = torch.cat(out, dim=1).cpu()
        if d.type == "cpu":
            cpu_tick = (time.perf_counter() - t0) / ticks
        finite &= bool(torch.isfinite(out).all()) and state["ec"]["Ws_r"].dtype == torch.float32
        outs.append(out.numpy())
    return outs[0], outs[1], finite, cpu_tick


# -- phase 7: the session layer ----------------------------------------------
class Session:
    """Echo-cancelling G.711 clients (AEC + AGC) against a conference
    server, both ``AudioStreamBatch`` on ``dev``: legs 4k..4k+3 form
    conference k (``AudioConferenceControl``), leg 4k talks. The clients'
    push is tapped for the talkers' sent codes and for finite speakers."""

    def __init__(self, dev, legs, ticks, seed=3):
        from mediastreamer2_tpu_torch import Factory
        from mediastreamer2_tpu_torch.models.audio_stream import (AudioStreamBatch,
                                                                  AudioStreamFeatures)
        from mediastreamer2_tpu_torch.models.conference import AudioConferenceControl
        from mediastreamer2_tpu_torch.utils.signals import make_speechlike
        self.legs, self.ticks = legs, ticks
        n = S8 * (ticks + 60)
        self.mic = np.zeros((legs, n), np.float32)
        for k in range(legs // 4):
            self.mic[4 * k] = make_speechlike(n, 8000, seed=seed + k)
        f = Factory()
        self.clients = AudioStreamBatch(
            f, legs, mic_signal=self.mic, record_ticks=ticks + 60, device=dev,
            features=AudioStreamFeatures(echo_canceller=True, agc=True))
        self.server = AudioStreamBatch(f, legs, conference=True, device=dev)
        self.ctl = AudioConferenceControl(self.server.ticker)
        for leg in range(legs):
            self.ctl.add_member(leg, leg // 4)
        self.sent, self.finite = [], [True]
        for s, keep in ((self.clients, True), (self.server, False)):
            s.ticker.realtime = False
            self._tap(s, keep)

    def _tap(self, stream, keep):
        push = stream.ticker._io_push

        def tapped(tick, out):
            if keep:
                self.sent.append(out["rtp_tx"][::4].copy())
            self.finite[0] &= bool(np.isfinite(out["spk"]).all())
            push(tick, out)
        stream.ticker.set_io(pull=stream.ticker._io_pull, push=tapped)

    def loopback(self):
        from mediastreamer2_tpu_torch.net.rtp import LoopbackPair
        for leg in range(self.legs):
            pair = LoopbackPair()
            self.clients.set_transport(leg, pair.endpoint(0))
            self.server.set_transport(leg, pair.endpoint(1))

    def alternate(self, ticks, sample_every=0):
        """``ticks`` rounds of clients.do_tick() then server.do_tick();
        returns host ms per round and the active talkers sampled every
        ``sample_every`` rounds."""
        samples = []
        t0 = time.perf_counter()
        for t in range(ticks):
            self.clients.ticker.do_tick()
            self.server.ticker.do_tick()
            if sample_every and t % sample_every == sample_every - 1:
                samples.append(self.ctl.active_talkers())
        return 1e3 * (time.perf_counter() - t0) / ticks, samples

    def state_finite(self):
        for s in (self.clients, self.server):
            s.ticker.sync()
        return all(bool(torch.isfinite(v).all())
                   for s in (self.clients, self.server)
                   for entry in s.ticker.state.values() if entry
                   for v in entry.values() if v.is_floating_point())

    def bars(self, conf_step):
        """Every ``conf_step``-th conference: each listener's recording
        against its talker's speech as sent (the talker's codes on the
        wire, decoded: the talker's own AEC and AGC shape it) and as
        spoken (its mic signal), and the talker's own energy against its
        listeners' (mix-minus)."""
        from mediastreamer2_tpu_torch.ops.g711 import pcm16_to_float, ulaw_decode
        from mediastreamer2_tpu_torch.utils.audiodiff import audio_diff
        n = S8 * self.ticks
        rec = self.clients.get_recording()[:, :n]
        sent = np.stack(self.sent)[:self.ticks]                  # [ticks, legs/4, 80]
        sent = pcm16_to_float(ulaw_decode(torch.from_numpy(sent.astype(np.int32)))).numpy()
        sim_sent, sim_mic, ratio = [], [], []
        for k in range(0, self.legs // 4, conf_step):
            said = sent[:, k].reshape(-1)
            e_talker = float((rec[4 * k] ** 2).mean())
            for leg in range(4 * k + 1, 4 * k + 4):
                sim_sent.append(audio_diff(said, rec[leg])[0])
                sim_mic.append(audio_diff(self.mic[4 * k, :n], rec[leg])[0])
                ratio.append(e_talker / (float((rec[leg] ** 2).mean()) + 1e-20))
        return min(sim_sent), min(sim_mic), max(ratio), rec

    def check(self, conf_step):
        """(bars met, a line that states them)."""
        sim_sent, sim_mic, ratio, _ = self.bars(conf_step)
        ok = sim_sent > 0.85 and sim_mic > 0.7 and ratio < 0.05 and self.finite[0]
        return ok, (f"listeners vs talkers (every {conf_step}th conference): audio_diff min "
                    f"{sim_sent:.4f} against the speech sent, {sim_mic:.4f} against the "
                    f"mic; talker/listener energy max {ratio:.2e}; outputs finite "
                    f"{self.finite[0]}, bars met {ok}")


def session_edge(kernels, dev, card, legs, ticks):
    """Phase 7a: the session pair at full width over localhost UDP through
    the native batched edge (UDP GSO only where the kernel takes it)."""
    from mediastreamer2_tpu_torch import native
    sess = Session(dev, legs, ticks)
    socks = []
    for _ in range(2):
        sk = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        sk.bind(("127.0.0.1", 0))
        sk.setblocking(False)
        for opt in (socket.SO_RCVBUF, socket.SO_SNDBUF):
            with contextlib.suppress(OSError):
                sk.setsockopt(socket.SOL_SOCKET, opt, 1 << 24)
        socks.append(sk)
    srv, cli = socks
    try:
        sess.clients.enable_batch_edge(rx_sock=cli, tx_sock=cli, remote=srv.getsockname(),
                                       ssrc_base=0x6000)
        sess.server.enable_batch_edge(rx_sock=srv, tx_sock=srv, remote=cli.getsockname(),
                                      ssrc_base=0x6000)
        sess.clients.ticker.warm_up()
        sess.server.ticker.warm_up()
        kernels.reset_launch_counts()
        ms, samples = sess.alternate(ticks, sample_every=10)
        launches = kernels.launch_counts()
        recv = [min(s._edge_rx.stats(i)["recv"] for i in range(legs))
                for s in (sess.server, sess.clients)]
    finally:
        srv.close()
        cli.close()
    ph = {f"{who} {k}": v / ticks for who, s in (("clients", sess.clients),
                                                 ("server", sess.server))
          for k, v in s.ticker.phase_ms.items() if not k.endswith("_max")}
    ok, line = sess.check(conf_step=4)
    named = {k: set() for k in range(legs // 4)}
    stray = set()
    for sample in samples:
        for conf, who in sample.items():
            named[conf].update(who)
            stray.update(leg for leg in who if leg % 4)
    missing = [k for k, who in named.items() if 4 * k not in who]
    state_finite = sess.state_finite()
    print(f"session 7a: {legs} + {legs} legs (AEC+AGC clients, conference server, "
          f"{legs // 4} four-party conferences) x {ticks} ticks over the batch edge, UDP GSO "
          f"{sess.server.gso}: {ms:.3f} ms per tick pair (host clock); host ms/tick by phase: "
          + " ".join(f"{k} {v:.3f}" for k, v in ph.items())
          + f"; launches {launches}; edge recv min server {recv[0]} clients {recv[1]}; "
          f"{line}; state finite {state_finite}; conferences whose talker was never named "
          f"{len(missing)}, listeners named {len(stray)} [{card}]", flush=True)
    # fused_volume: the clients' vol_send and vol_recv, and the server's
    # vol_recv (a conference=True stream has no send volume, in the JAX
    # package too)
    want = {"fused_volume": 3 * ticks, "mdf_apply": ticks, "mdf_update": 0,
            "mdf_update_fused": ticks}
    _require_counts("session 7a", launches, want)
    if min(recv) < ticks // 2:
        raise AssertionError(f"session 7a: a leg received only {min(recv)} packets")
    if missing or stray or not (state_finite and ok):
        raise AssertionError(f"session 7a: talkers not named in conferences {missing[:8]}, "
                             f"listeners named {sorted(stray)[:8]}, state finite {state_finite}")
    return launches


def session_paced(dev, card, legs, ticks):
    """Phase 7b: the session pair over LoopbackPair (the per-leg RtpSession
    path), both tickers warmed, then start()ed paced on their own threads:
    the clients for ``ticks`` ticks, the server until 20 ticks after them."""
    sess = Session(dev, legs, ticks, seed=40)
    sess.loopback()
    for s in (sess.server, sess.clients):
        s.ticker.realtime = True
        s.ticker.warm_up()
    sess.server.ticker.start()
    sess.clients.ticker.start(ticks)
    sess.clients.ticker._run_thread.join(timeout=30 + ticks * 0.05)
    alive = sess.clients.ticker._run_thread.is_alive()
    time.sleep(0.2)
    for s in (sess.clients, sess.server):
        s.stop()
    if alive:
        raise AssertionError("session 7b: the paced clients did not finish")
    jb = [s.sessions[0].jitter_buffer for s in (sess.server, sess.clients)]
    st = [(s.ticker.stats.ticks, s.ticker.stats.late_ticks, s.ticker.get_average_load(),
           s.ticker.stats.mean_step_ms) for s in (sess.clients, sess.server)]
    ok, line = sess.check(conf_step=1)
    print(f"session 7b: {legs} + {legs} legs x {ticks} ticks paced over LoopbackPair, "
          + ", ".join(f"{who} {n} ticks, late {late}, load {load:.3f}, mean {mean:.3f} ms"
                      for who, (n, late, load, mean) in zip(("clients", "server"), st))
          + "; host ms/tick by phase: " + " ".join(
              f"{who} {k} {v / s.ticker.stats.ticks:.3f}"
              for who, s in (("clients", sess.clients), ("server", sess.server))
              for k, v in s.ticker.phase_ms.items() if not k.endswith("_max"))
          + f"; leg 0 jitter buffer underruns server {jb[0].underruns} clients "
          f"{jb[1].underruns}; {line} [{card}]", flush=True)
    if not ok:
        raise AssertionError("session 7b: bars not met")


def session_cross(dev, legs, ticks):
    """Phase 7c: the same session on the CPU (plain versions) and on the
    card (kernels), over LoopbackPair with alternating do_tick; returns
    the clients' recordings of the listeners, CPU then card."""
    recs = []
    for d in (torch.device("cpu"), dev):
        sess = Session(d, legs, ticks, seed=70)
        sess.loopback()
        sess.alternate(ticks)
        ok, line = sess.check(conf_step=1)
        if not ok:
            raise AssertionError(f"session 7c on {d.type}: {line}")
        rec = sess.clients.get_recording()[:, :S8 * ticks]
        recs.append(rec[[leg for leg in range(legs) if leg % 4]])
    return recs


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false); this script runs only on the card")
    sys.path.insert(0, REPO)
    from mediastreamer2_tpu_torch import native
    from mediastreamer2_tpu_torch.models.flagship import echo_coupled_inputs
    from mediastreamer2_tpu_torch.ops import kernels
    from mediastreamer2_tpu_torch.utils.audiodiff import quality_bar

    dev = torch.device("cuda", 0)
    card = card_line()
    # phase 1: environment and build
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:     # nvcc and g++ side by side
        k_build = pool.submit(kernels.build)
        e_build = pool.submit(native.build)
        lib, log = k_build.result()
        edge = e_build.result()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {os.path.relpath(lib, REPO)}, "
          f"{os.path.relpath(edge, REPO)}", flush=True)
    if log.strip():
        print(log.strip(), flush=True)

    # phase 2: kernels against their plain versions on the card, at the
    # flagship's shapes and at the session's
    results = kernel_checks(kernels, dev, card, LEGS, S, P, F)
    session_results = kernel_checks(kernels, dev, card, SESSION_LEGS, S8, SP, SF, full=False)

    # phase 3: the flagship at 4,096 legs, counted launches
    mic, far = echo_coupled_inputs(LEGS, TICKS, seed=11)
    kernels.reset_launch_counts()
    state, out, finite, per_tick = run_flagship(LEGS, TICKS, dev, mic, far)
    launches = kernels.launch_counts()
    del mic, far
    ec = state["ec"]
    conv = float((ec["Es"] < 0.5 * ec["Dn"]).float().mean())
    tap_mb = sum(ec[k].numel() * ec[k].element_size()
                 for k in ("Wm_r", "Wm_i", "Ws_r", "Ws_i", "Xh_r", "Xh_i")) / 1e6
    print(f"flagship: {LEGS} legs x {TICKS} ticks, {1e3 * per_tick:.3f} ms/tick "
          f"(host clock, ticks 1..{TICKS - 1}), AEC taps+history {tap_mb:.1f} MB, "
          f"launches {launches}, finite {finite}, shadow converged on "
          f"{100 * conv:.1f}% of legs, out {tuple(out.shape)} [{card}]", flush=True)
    _require_counts("flagship", launches, {"fused_volume": TICKS, "mdf_apply": TICKS,
                                           "mdf_update": 0, "mdf_update_fused": TICKS})
    if not finite:
        raise AssertionError("flagship output holds non-finite values")
    if tuple(out.shape) != (LEGS, TICKS * 160):
        raise AssertionError(f"flagship output shape {tuple(out.shape)}")
    if conv < 0.9:
        raise AssertionError(f"shadow filter converged on only {100 * conv:.1f}% of legs")
    del state, out

    # phase 4: the port on the CPU against the port on the card
    mic, far = echo_coupled_inputs(CROSS_LEGS, CROSS_TICKS, seed=7)
    _, out_cpu, fin_cpu, cpu_tick = run_flagship(CROSS_LEGS, CROSS_TICKS,
                                              torch.device("cpu"), mic, far)
    _, out_gpu, fin_gpu, _ = run_flagship(CROSS_LEGS, CROSS_TICKS, dev, mic, far)
    bar = quality_bar(out_cpu.numpy(), out_gpu.cpu().numpy())
    print(f"cpu vs gpu: {CROSS_LEGS} legs x {CROSS_TICKS} ticks, "
          f"audio_diff_min {bar['audio_diff_min']:.6f} (legs 0, 37, ...; all legs "
          f"{bar['audio_diff_min_all_legs']:.6f}, {bar['legs_below_0.999']} below "
          f"0.999), rms_err {bar['rms_err']:.3e}, max_abs_err {bar['max_abs_err']:.3e}, "
          f"energy_gap_db_max {bar['energy_gap_db_max']:.4f}, pass {bar['pass']} "
          f"(cpu {1e3 * cpu_tick:.1f} ms/tick)", flush=True)
    if not (bar["pass"] and fin_cpu and fin_gpu):
        raise AssertionError(f"cpu vs gpu quality bar failed: {bar}")

    # phase 5: the e2e leg over localhost UDP, megakernel AEC
    with environ(PALLAS_MDF="1"):
        res, e2e_launches, e2e_ticks = run_e2e(kernels, dev, card, E2E_LEGS, E2E_TICKS,
                                               paced=True)
        if not (res.loss_rate < 0.02 and res.fidelity >= 0.9):
            raise AssertionError(f"e2e bar failed: {res}")
        _, big_launches, big_ticks = run_e2e(kernels, dev, card, E2E_BIG_LEGS,
                                             E2E_BIG_TICKS, paced=False)

    # phase 6: the e2e graph without the network, the CPU against the card
    with environ(PALLAS_MDF="1"):
        out_cpu, out_gpu, fin, cpu_tick = e2e_cross(dev, CROSS_LEGS, CROSS_TICKS)
    bar = quality_bar(out_cpu, out_gpu)
    print(f"e2e cpu vs gpu: {CROSS_LEGS} legs x {CROSS_TICKS} ticks, megakernel AEC, "
          f"audio_diff_min {bar['audio_diff_min']:.6f} (legs 0, 37, ...; all legs "
          f"{bar['audio_diff_min_all_legs']:.6f}, {bar['legs_below_0.999']} below "
          f"0.999), rms_err {bar['rms_err']:.3e}, max_abs_err {bar['max_abs_err']:.3e}, "
          f"energy_gap_db_max {bar['energy_gap_db_max']:.4f}, pass {bar['pass']} "
          f"(cpu {1e3 * cpu_tick:.1f} ms/tick)", flush=True)
    if not (bar["pass"] and fin):
        raise AssertionError(f"e2e cpu vs gpu quality bar failed: {bar}")

    # phase 7: the session layer (AudioStreamBatch, Ticker, conference
    # control): 7a full width over the batch edge, 7b paced threads over
    # loopback RTP, 7c the CPU against the card
    session_launches = session_edge(kernels, dev, card, SESSION_LEGS, SESSION_TICKS)
    session_paced(dev, card, PACED_LEGS, PACED_TICKS)
    rec_cpu, rec_gpu = session_cross(dev, CROSS_SESSION_LEGS, CROSS_SESSION_TICKS)
    bar = quality_bar(rec_cpu, rec_gpu, leg_step=1)
    print(f"session cpu vs gpu: {CROSS_SESSION_LEGS} + {CROSS_SESSION_LEGS} legs x "
          f"{CROSS_SESSION_TICKS} ticks over LoopbackPair, the clients' recordings of "
          f"every listener: audio_diff_min {bar['audio_diff_min']:.6f}, rms_err "
          f"{bar['rms_err']:.3e}, max_abs_err {bar['max_abs_err']:.3e}, energy_gap_db_max "
          f"{bar['energy_gap_db_max']:.4f}, pass {bar['pass']}", flush=True)
    if not bar["pass"]:
        raise AssertionError(f"session cpu vs gpu quality bar failed: {bar}")

    # launches over the main-path runs that were counted: the flagship, both
    # e2e runs and the session at full width
    runs = {"flagship": (launches, TICKS),
            "e2e": ({k: e2e_launches[k] + big_launches[k] for k in launches},
                    e2e_ticks + big_ticks),
            "session": (session_launches, SESSION_TICKS)}
    total = {k: sum(c[k] for c, _ in runs.values()) for k in launches}
    entries = []
    for name in REPLACES:
        r = results[name]
        entry = {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                 "replaces": REPLACES[name], "launches": total[name],
                 "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
                 "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
                 "launches_per_tick": {path: c[name] / n for path, (c, n) in runs.items()}}
        if name in session_results:
            sr = session_results[name]
            entry["session_shapes"] = {k: sr[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                         "bound_ms", "bound_by")}
        entries.append(entry)
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
