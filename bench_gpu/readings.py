"""The readings that a cell's limits are set from, on the card at the
cell's own size: the program on many seeds and the control (the reference
in the program's place, products in TF32) on a few, each through a short
window, all in one process.

    python3 -m bench_gpu.readings --workload flagship48k.unpaced \\
        --seeds 11 12 ... --control-seeds 21 22 23 --seconds 1

One JSON line a run: the variant, the seed and the compared numbers. The
lower reading of a number is the largest over the program's seeds, its
upper reading the smallest over the control's; the configuration's limit
lies between them (see PERF.md).
"""
import argparse
import gc
import json
import time

import torch

from bench_gpu import harness


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args()
    runs = [("port", s) for s in args.seeds] + [("control", s) for s in args.control_seeds]
    for variant, seed in runs:
        t0 = time.perf_counter()
        cell = harness.Cell(args.workload, seed, "cuda", variant=variant)
        result = cell.run(args.seconds, False, t0, harness.BENCH_DIR / "out")
        numbers = {k: v["value"] for k, v in result["compared"].items()}
        print(json.dumps({"variant": variant, "seed": seed, "correct": result["correct"],
                          "numbers": numbers, "notes": cell.notes[-2:], "run_s": time.perf_counter() - t0}), flush=True)
        del cell
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
