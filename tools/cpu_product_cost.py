#!/usr/bin/env python3
"""What the port's row-invariant CPU products cost (``ops/rfft.rowwise_mm``):
each DFT and resampler shape as a plain ``x @ w`` and through
``rowwise_mm``, at a few batch sizes and thread counts, then the flagship
graph's tick on the CPU at a few batch sizes (with whichever products this
checkout has, so that two checkouts compare by running it in each).

    python3 tools/cpu_product_cost.py [--legs 8 64 256] [--threads 1 8]

Runs on the CPU only; every time is the median of repeated calls on the
host's clock.
"""
import argparse
import os
import statistics
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mediastreamer2_tpu_torch import Factory, build_flagship  # noqa: E402
from mediastreamer2_tpu_torch.models.flagship import echo_coupled_inputs  # noqa: E402
from mediastreamer2_tpu_torch.ops import rfft  # noqa: E402

SHAPES = ((960, 481), (481, 960), (160, 81), (81, 160), (832, 160))   # (K, N)
PRODUCT_ROWS = (8, 1024)


def median_ms(fn, reps):
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return 1e3 * statistics.median(times)


def products(threads):
    rng = np.random.default_rng(0)
    for k, n in SHAPES:
        w = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
        for rows in PRODUCT_ROWS:
            x = torch.from_numpy(rng.standard_normal((rows, k)).astype(np.float32))
            reps = max(5, 2000 // rows)
            plain = median_ms(lambda: x @ w, reps)
            line = f"threads {threads} product [{rows}, {k}] @ [{k}, {n}]: plain {plain:.4f} ms"
            if hasattr(rfft, "rowwise_mm"):
                rw = median_ms(lambda: rfft.rowwise_mm(x, w), reps)
                line += f", rowwise_mm {rw:.4f} ms (x{rw / plain:.2f})"
            print(line, flush=True)


def flagship_tick(threads, legs, ticks=6):
    cg, params = build_flagship(Factory(), legs, "cpu")
    state = cg.init_state("cpu")
    mic, far = echo_coupled_inputs(legs, ticks)
    S = mic.shape[1] // ticks
    times = []
    for t in range(ticks):
        ext = {"mic": torch.from_numpy(mic[:, t * S:(t + 1) * S].copy()),
               "spk_ref": torch.from_numpy(far[:, t * S:(t + 1) * S].copy())}
        t0 = time.perf_counter()
        state, _, _ = cg.step(state, params, ext)
        times.append(time.perf_counter() - t0)
    print(f"threads {threads} flagship tick on the CPU at {legs} legs: "
          f"{1e3 * statistics.median(times[1:]):.3f} ms (median of ticks 1..{ticks - 1})",
          flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--legs", type=int, nargs="*", default=[8, 64, 256])
    ap.add_argument("--threads", type=int, nargs="*", default=[1, 8])
    args = ap.parse_args()
    for threads in args.threads:
        torch.set_num_threads(threads)
        products(threads)
        for legs in args.legs:
            flagship_tick(threads, legs)


if __name__ == "__main__":
    main()
