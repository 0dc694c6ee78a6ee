#!/usr/bin/env python3
"""Does ``time.monotonic()`` ever step back within one thread on this
machine? Reads it ``--reads`` times in a tight loop, with a short sleep
every ``--yield-every`` reads so that the thread can move between CPUs,
and prints the backward steps counted and the largest one. Then repeats
chip_smoke.py's phase 12c (``video_cross``: 4 + 4 video legs over
LoopbackPair, the CPU against the card) ``--cross`` times and prints each
run's frames received, so that a missed frame can be set beside the
clock's behaviour.

    python3 tools/monotonic_probe.py [--reads 20000000] [--cross 10]

The clock part runs anywhere; ``--cross`` needs a CUDA card (0 skips it).
"""
import argparse
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def backward_steps(reads: int, yield_every: int):
    """(steps back, the largest step back in s, reads)."""
    mono = time.monotonic
    back, worst = 0, 0.0
    prev = mono()
    for i in range(reads):
        now = mono()
        if now < prev:
            back += 1
            worst = max(worst, prev - now)
        prev = now
        if yield_every and i % yield_every == 0:
            time.sleep(0)
    return back, worst, reads


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reads", type=int, default=20_000_000)
    ap.add_argument("--yield-every", type=int, default=1000)
    ap.add_argument("--cross", type=int, default=10)
    args = ap.parse_args()
    t0 = time.perf_counter()
    back, worst, n = backward_steps(args.reads, args.yield_every)
    print(f"time.monotonic: {back} steps back in {n} reads (largest {worst * 1e9:.0f} ns), "
          f"{time.perf_counter() - t0:.1f} s, {os.cpu_count()} CPUs", flush=True)
    if args.cross:
        import torch
        import chip_smoke
        if not torch.cuda.is_available():
            raise SystemExit("monotonic_probe: --cross needs a CUDA device")
        card = chip_smoke.card_line()
        failed = 0
        for i in range(args.cross):
            try:
                chip_smoke.video_cross(torch.device("cuda", 0), card)
            except AssertionError as e:
                failed += 1
                print(f"12c run {i}: {e}", flush=True)
        print(f"12c: {failed} of {args.cross} runs failed [{card}]", flush=True)


if __name__ == "__main__":
    main()
