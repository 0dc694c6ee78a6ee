#!/usr/bin/env python3
"""Phase 15 of chip_smoke.py (leg sharding) alone on the card, run
``--runs`` times: 15a / 15b the flagship sharded four ways over gloo
against the unsharded run, the mixer alone bit for bit, 15c the dry run,
15d one NCCL rank, 15e the offset kernel and the shards' taps. Each run
prints chip_smoke.py's lines and its seconds; any failed bar ends the
script non-zero, as in chip_smoke.py. Builds the kernels and the edge
first, as phase 1 does.

    python3 tools/phase15_runs.py [--runs 1] [--legs 4096] [--world 4]

Needs one CUDA card (``--device cpu --legs 8 --ticks 3 --world 2``
rehearses it on the CPU, without 15d).
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
    ap.add_argument("--runs", type=int, default=1)
    ap.add_argument("--legs", type=int, default=chip_smoke.SHARD_LEGS)
    ap.add_argument("--ticks", type=int, default=chip_smoke.SHARD_TICKS)
    ap.add_argument("--world", type=int, default=chip_smoke.SHARD_WORLD)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("phase15_runs: no CUDA device")
    card = chip_smoke.card_line() if dev.type == "cuda" else "cpu"
    if dev.type == "cpu":
        torch.set_num_threads(1)    # as the shards: the CPU's DFT products follow the thread count
    from mediastreamer2_tpu_torch import native
    from mediastreamer2_tpu_torch.ops import kernels
    t0 = time.perf_counter()
    if dev.type == "cuda":
        kernels.build()
    native.build()
    print(f"build: {time.perf_counter() - t0:.1f} s [{card}]", flush=True)
    legs = args.legs
    for i in range(args.runs):
        t0 = time.perf_counter()
        launches, n = chip_smoke.phase15(
            kernels, dev, card, legs=legs, ticks=args.ticks, world=args.world,
            conferences=legs // 4, nccl_legs=min(legs, chip_smoke.NCCL_LEGS),
            offset_rows=(legs // 4, legs // 2))
        print(f"phase 15 run {i}: launches {launches} over {n} rank ticks, "
              f"{time.perf_counter() - t0:.1f} s [{card}]", flush=True)


if __name__ == "__main__":
    main()
