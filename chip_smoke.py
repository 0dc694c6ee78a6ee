#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (mediastreamer2_tpu_torch) on one
NVIDIA GPU: builds its kernels from source, checks each against its plain
PyTorch version on the card, drives the flagship conference leg, and
compares the port on the card with the port on the CPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc and nvidia-smi; imports nothing of JAX. Phases,
in order (any failure raises and the script exits non-zero):

1. card, versions, kernel build time;
2. each kernel against its plain version at the flagship's shapes, with
   median times (CUDA events, 50 reps);
3. the flagship at 4,096 legs (1,024 four-party conferences) for 100
   ticks of echo-coupled input: every kernel launched once per tick, all
   outputs finite, the AEC's shadow filter converged (Es < 0.5 * Dn) on
   >= 90% of legs; ms/tick;
4. the port on the CPU (plain versions) against the port on the card
   (kernels) on the cross-backend fixture (256 legs, 100 ticks), held to
   the bar of tools/tpu_correctness.py: audio_diff >= 0.999 on legs 0, 37,
   74, ... (the all-legs minimum is printed too), rms error <= 5e-3, and
   per-leg energy gap <= 1.5 dB.

The last two lines of standard output are the kernels' JSON and the
result's JSON; the card's name and power limit come before them.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "mediastreamer2_tpu_torch/csrc/ms2_kernels.cu"
REPLACES = {  # the TPU kernel each CUDA kernel replaces
    "fused_volume": "mediastreamer2_tpu/ops/pallas_kernels.py:56",
    "mdf_apply": "mediastreamer2_tpu/ops/pallas_kernels.py:133",
    "mdf_update_fused": "mediastreamer2_tpu/ops/pallas_kernels.py:278",
}
LEGS = 4096
TICKS = 100
CROSS_LEGS = 256
CROSS_TICKS = 100
P, F, S = 8, 481, 480


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def median_ms(fn, reps: int = 50) -> float:
    """Median of per-launch CUDA-event times after 3 warm-up calls."""
    for _ in range(3):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for a, b in pairs:
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in pairs]))


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def _require_equal(name, got, want):
    if not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from its plain version "
                             f"(max abs err {_max_err(got, want)})")


def kernel_checks(kernels, dev, card):
    """Phase 2: each kernel against its plain version on the card."""
    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *shape, s=1.0: s * torch.randn(shape, generator=g, device=dev)
    legs = lambda: torch.rand((LEGS,), generator=g, device=dev) < 0.3
    results = {}

    # fused_volume: [4096, 480] f32; sums run in another order (rtol 1e-5)
    x = rnd(LEGS, S, s=0.5)
    vargs = (x, rnd(LEGS).abs() + 0.1, rnd(LEGS).abs() + 0.1, rnd(LEGS, s=0.05),
             (torch.rand((LEGS,), generator=g, device=dev) < 0.5).float())
    got = kernels.fused_volume(*vargs)
    want = kernels.fused_volume_reference(*vargs)
    err = 0.0
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        err = max(err, _max_err(a, b))
    results["fused_volume"] = {
        "max_abs_err": err, "tolerance": "rtol 1e-5, atol 1e-6",
        "ms": median_ms(lambda: kernels.fused_volume(*vargs)),
        "plain_ms": median_ms(lambda: kernels.fused_volume_reference(*vargs))}

    # mdf_apply: [4096, 8, 481] bf16, bit-exact (no FMA contraction)
    taps = [rnd(LEGS, P, F, s=0.1).to(torch.bfloat16) for _ in range(4)]
    hist = [rnd(LEGS, P, F).to(torch.bfloat16) for _ in range(2)]
    blk = [rnd(LEGS, F) for _ in range(2)]
    h_k = [h.clone() for h in hist]
    h_p = [h.clone() for h in hist]
    got = kernels.mdf_apply(*taps, *h_k, *blk)
    want = kernels.mdf_apply_reference(*taps, *h_p, *blk)
    for i, (a, b) in enumerate(zip(got + tuple(h_k), want + tuple(h_p))):
        _require_equal(f"mdf_apply output {i}", a, b)
    results["mdf_apply"] = {
        "max_abs_err": 0.0, "tolerance": "bit-exact",
        "ms": median_ms(lambda: kernels.mdf_apply(*taps, *h_k, *blk)),
        "plain_ms": median_ms(lambda: kernels.mdf_apply_reference(*taps, *h_p, *blk))}

    # mdf_update_fused: the f32 shadow mode at cpos 3, then the bf16 shadow
    # (default, timed) at cpos 0, 3, 7; 30% of legs promoted, reseeded or
    # hard-reset
    spec = [rnd(LEGS, F, s=0.3), rnd(LEGS, F, s=0.3), rnd(LEGS, F).abs(),
            rnd(LEGS, F, s=0.05), rnd(LEGS, F, s=0.05)]
    mu = rnd(LEGS).abs() * 0.6
    flags = [legs(), legs(), legs()]
    flags[0] &= ~flags[2]
    srk = torch.tensor(123456789, dtype=torch.int64, device=dev)
    for cpos_v, sdt in ((3, torch.float32), (0, torch.bfloat16),
                        (3, torch.bfloat16), (7, torch.bfloat16)):
        cpos = torch.tensor(cpos_v, dtype=torch.int32, device=dev)
        ws = [rnd(LEGS, P, F, s=0.1).to(torch.bfloat16).to(sdt) for _ in range(2)]
        wm = [rnd(LEGS, P, F, s=0.1).to(torch.bfloat16) for _ in range(2)]
        st_k = [t.clone() for t in ws + wm]
        st_p = [t.clone() for t in ws + wm]
        kernels.mdf_update_fused(cpos, *st_k, *hist, *spec, mu, *flags, srk)
        kernels.mdf_update_fused_reference(cpos, *st_p, *hist, *spec, mu, *flags, srk)
        for name, a, b in zip(("Ws_r", "Ws_i", "Wm_r", "Wm_i"), st_k, st_p):
            _require_equal(f"mdf_update_fused {name} cpos={cpos_v} {sdt}", a, b)
    results["mdf_update_fused"] = {
        "max_abs_err": 0.0, "tolerance": "bit-exact",
        "ms": median_ms(lambda: kernels.mdf_update_fused(cpos, *st_k, *hist, *spec,
                                                         mu, *flags, srk)),
        "plain_ms": median_ms(lambda: kernels.mdf_update_fused_reference(
            cpos, *st_p, *hist, *spec, mu, *flags, srk))}
    for name, r in results.items():
        print(f"kernel {name}: matches plain ({r['tolerance']}, max abs err "
              f"{r['max_abs_err']}); median {r['ms']:.4f} ms vs plain "
              f"{r['plain_ms']:.4f} ms [{card}]", flush=True)
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false); this script runs only on the card")
    sys.path.insert(0, REPO)
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
    lib, log = kernels.build()
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{os.path.relpath(lib, REPO)}", flush=True)
    if log.strip():
        print(log.strip(), flush=True)

    # phase 2: kernels against their plain versions on the card
    results = kernel_checks(kernels, dev, card)

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
    if any(n != TICKS for n in launches.values()):
        raise AssertionError(f"each kernel must launch once per tick: {launches}")
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

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"]}
        for name, r in results.items()]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
