#!/usr/bin/env python3
"""Threads per block of the DVI4 and G.726 kernels (csrc/adpcm_kernels.cu):
build the port's kernels once per candidate with -DADPCM_THREADS=n and time
each codec kernel on the card at B legs of one 80-sample tick, device time
per launch as chip_smoke.py measures it (the stream spins, then one event
pair around 50 launches, over input sets that spill the L2). The DVI4
decoder's block is four warps whatever ADPCM_THREADS is.

    python3 tools/adpcm_block_size.py [--legs 1024] [--threads 32 64 128]
                                      [--source other_adpcm_kernels.cu ...]

Needs one CUDA card and nvcc. Prints one line per source, candidate and
kernel, with the card's name and power limit; candidates are timed in
turns, twice (32, 64, 128, 128, 64, 32), so that drift shows. ``--source``
times other versions of the source (an earlier commit's, say) beside the
checkout's in the same call.
"""
import argparse
import os
import sys
from pathlib import Path

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import chip_smoke  # noqa: E402
from g726_variants import use  # noqa: E402
from mediastreamer2_tpu_torch.ops import kernels  # noqa: E402
from mediastreamer2_tpu_torch.ops.g726 import g726_state  # noqa: E402


def time_kernels(legs, dev):
    S = chip_smoke.S8
    pcm = torch.from_numpy(chip_smoke.speech_fixture(legs, S, seed=2)).to(dev)
    zeros = lambda: torch.zeros((legs,), dtype=torch.int32, device=dev)   # noqa: E731
    n_sets = chip_smoke.rotation(chip_smoke.adpcm_cost(legs, S, "g726_encode", 4)[0])
    out = {}
    codes = kernels.dvi4_encode(pcm, zeros(), zeros())[0]
    sets = [(pcm.clone(), zeros(), zeros()) for _ in range(n_sets)]
    out["dvi4_encode"] = chip_smoke.device_ms(lambda i: kernels.dvi4_encode(*sets[i % n_sets]))
    sets = [(codes.clone(), zeros(), zeros()) for _ in range(n_sets)]
    out["dvi4_decode"] = chip_smoke.device_ms(lambda i: kernels.dvi4_decode(*sets[i % n_sets]))
    codes = kernels.g726_encode(pcm, g726_state(legs, dev), 4)[0]
    sets = [(pcm.clone(), g726_state(legs, dev)) for _ in range(n_sets)]
    out["g726_encode@32"] = chip_smoke.device_ms(
        lambda i: kernels.g726_encode(*sets[i % n_sets], 4))
    sets = [(codes.clone(), g726_state(legs, dev)) for _ in range(n_sets)]
    out["g726_decode@32"] = chip_smoke.device_ms(
        lambda i: kernels.g726_decode(*sets[i % n_sets], 4))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--legs", type=int, default=1024)
    ap.add_argument("--threads", type=int, nargs="+", default=[32, 64, 128])
    ap.add_argument("--source", nargs="*", default=[],
                    help="other versions of csrc/adpcm_kernels.cu to time beside it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("adpcm_block_size: no CUDA device")
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    versions = [kernels.SOURCES[2]] + [Path(p).resolve() for p in args.source]
    for n in args.threads + args.threads[::-1]:
        for src in versions:
            use(src, (f"ADPCM_THREADS={n}",))     # load this candidate's build
            for name, ms in time_kernels(args.legs, dev).items():
                print(f"{os.path.relpath(src, REPO)} ADPCM_THREADS={n} B={args.legs} {name}: "
                      f"{ms:.4f} ms per launch [{card}]", flush=True)


if __name__ == "__main__":
    main()
