#!/usr/bin/env python3
"""Phase 7b of chip_smoke.py, run again and again on the card: 64 + 64
mu-law session legs (echo-cancelling clients against a conference server),
each ticker paced on its own thread over LoopbackPair. Every run prints
chip_smoke.py's 7b line (each listener's audio_diff at one lag and that
lag, its similarity along the path its packets took, the share of its
ticks played, and its jitter buffers' counters); the runs whose bars fail
are counted.

    python3 tools/phase7b_runs.py [--runs 10]

Needs one CUDA card (``--device cpu`` rehearses it on the CPU with
``--legs 8 --ticks 80``).
"""
import argparse
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--legs", type=int, default=chip_smoke.PACED_LEGS)
    ap.add_argument("--ticks", type=int, default=chip_smoke.PACED_TICKS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("phase7b_runs: no CUDA device")
    card = chip_smoke.card_line() if dev.type == "cuda" else "cpu"
    failed = []
    for i in range(args.runs):
        try:
            chip_smoke.session_paced(dev, card, args.legs, args.ticks)
        except AssertionError as e:
            failed.append(i)
            print(f"run {i}: {e}", flush=True)
    print(f"phase 7b: {len(failed)} of {args.runs} runs failed {failed} [{card}]", flush=True)


if __name__ == "__main__":
    main()
