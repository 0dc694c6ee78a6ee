#!/usr/bin/env python3
"""Phase 13 of chip_smoke.py (the SFU and the call's side channels) alone
on the card, run ``--runs`` times: 13a the audio SFU at 1,024 participants
through the native receive pump, 13b 8b's session over UDP with Python
receive and with the pump, 13c the video router with FlexFEC, 13d text
and UPnP, 13e the SFU's path on the CPU against the card. Each run prints
chip_smoke.py's lines and its seconds; any failed bar ends the script
non-zero, as in chip_smoke.py.

    python3 tools/phase13_runs.py [--runs 3]

Needs one CUDA card (``--device cpu --conferences 1 --legs 4`` rehearses it
on the CPU).
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
    ap.add_argument("--conferences", type=int, default=chip_smoke.SFU_CONFERENCES)
    ap.add_argument("--ticks", type=int, default=chip_smoke.SFU_TICKS)
    ap.add_argument("--legs", type=int, default=chip_smoke.PUMP_SESSION_LEGS,
                    help="13b's legs a side")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("phase13_runs: no CUDA device")
    card = chip_smoke.card_line() if dev.type == "cuda" else "cpu"
    from mediastreamer2_tpu_torch.ops import kernels
    for i in range(args.runs):
        t0 = time.perf_counter()
        _, ranks, _ = chip_smoke.audio_sfu(kernels, dev, card, args.conferences, args.ticks)
        ms = [chip_smoke.pump_session(dev, card, args.legs, pumped) for pumped in (False, True)]
        print(f"session 13b: ms per tick pair, Python receive {ms[0]:.3f}, NativeIoPump "
              f"{ms[1]:.3f} [{card}]", flush=True)
        chip_smoke.video_router_fec(card, ranks)
        chip_smoke.text_streams(card)
        chip_smoke.upnp_mapping(card)
        chip_smoke.sfu_cross(dev, card)
        print(f"phase 13 run {i}: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)


if __name__ == "__main__":
    main()
