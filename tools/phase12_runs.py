#!/usr/bin/env python3
"""Phase 12 of chip_smoke.py (the video call) alone on the card, run
``--runs`` times: 12a the pixel path at 1,024 VGA-to-QVGA legs, 12b
VideoE2EBench over localhost UDP and the library codecs' refusals, 12c
the CPU against the card. Each run prints chip_smoke.py's lines and its
seconds; any failed bar ends the script non-zero, as in chip_smoke.py.

    python3 tools/phase12_runs.py [--runs 3]

Needs one CUDA card (``--device cpu --legs 8 --ticks 10`` rehearses it on
the CPU).
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
    ap.add_argument("--legs", type=int, default=chip_smoke.VIDEO_LEGS)
    ap.add_argument("--ticks", type=int, default=chip_smoke.VIDEO_TICKS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("phase12_runs: no CUDA device")
    card = chip_smoke.card_line() if dev.type == "cuda" else "cpu"
    from mediastreamer2_tpu_torch.ops import kernels
    for i in range(args.runs):
        t0 = time.perf_counter()
        chip_smoke.video_pixel_path(kernels, dev, card, args.legs, args.ticks)
        chip_smoke.video_e2e(dev, card, chip_smoke.VIDEO_E2E_LEGS)
        chip_smoke.video_codec_refusals(dev, card)
        chip_smoke.video_cross(dev, card)
        print(f"phase 12 run {i}: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)


if __name__ == "__main__":
    main()
