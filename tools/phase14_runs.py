#!/usr/bin/env python3
"""Phase 14 of chip_smoke.py (the mixed fleet, the host-codec legs and the
device layer) alone on the card, run ``--runs`` times: 14a the fleet in
one paced loop, 14b in per-member threads, 14c the host-codec legs, 14d
the quirk session on sound cards at full width, 14e the same at 4 + 4 legs
on the CPU against the card, 14f the device gating and the mire. Each run
prints chip_smoke.py's lines and its seconds; any failed bar ends the
script non-zero, as in chip_smoke.py.

    python3 tools/phase14_runs.py [--runs 3] [--seconds 8]

Needs one CUDA card (``--device cpu --flagship 8 --srtp 4 --legs 8``
rehearses it on the CPU).
"""
import argparse
import os
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=chip_smoke.FLEET_SECONDS)
    ap.add_argument("--flagship", type=int, default=chip_smoke.FLEET_FLAGSHIP)
    ap.add_argument("--srtp", type=int, default=chip_smoke.FLEET_SRTP)
    ap.add_argument("--legs", type=int, default=chip_smoke.QUIRK_LEGS, help="14d's legs a side")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("phase14_runs: no CUDA device")
    card = chip_smoke.card_line() if dev.type == "cuda" else "cpu"
    from mediastreamer2_tpu_torch.ops import kernels
    from mediastreamer2_tpu_torch.utils.audiodiff import quality_bar
    _, ns, no, nv = chip_smoke.fleet_sizes()
    sizes = (args.flagship, args.srtp, no, nv)
    for i in range(args.runs):
        t0 = time.perf_counter()
        for mode in ("loop", "threads"):
            chip_smoke.fleet_run(kernels, dev, card, mode, seconds=args.seconds, sizes=sizes)
        chip_smoke.host_codec_legs(dev, card)
        chip_smoke.session_edge(kernels, dev, card, args.legs, chip_smoke.QUIRK_TICKS,
                                phase="14d", sound_card=True)
        rec_cpu, rec_dev = chip_smoke.session_cross(dev, chip_smoke.CROSS_QUIRK_LEGS,
                                                    chip_smoke.CROSS_QUIRK_TICKS, sound_card=True)
        bar = quality_bar(rec_cpu, rec_dev, leg_step=1)
        print(f"session 14e: audio_diff_min {bar['audio_diff_min']:.6f}, rms_err "
              f"{bar['rms_err']:.3e}, energy_gap_db_max {bar['energy_gap_db_max']:.4f}, pass "
              f"{bar['pass']}", flush=True)
        if not bar["pass"]:
            raise AssertionError(f"session 14e cpu vs card quality bar failed: {bar}")
        chip_smoke.device_gating(dev, card)
        print(f"phase 14 run {i}: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)


if __name__ == "__main__":
    main()
