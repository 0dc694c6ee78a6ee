"""Find the knee of a paced cell once: its traffic at several leg counts,
each in the open loop for a few seconds, on the card.

    python3 -m bench_gpu.sweep --workload flagship48k.paced --seconds 5 \\
        --legs 16384 17408 ...

For each width it prints the tick latency's median, 95th percentile and
largest, the late ticks (over the interval), and the backlog's growth: the
median latency of the window's last quarter less its first quarter's. The
knee is the widest count whose p95 stays at or under the interval with no
growth; the paced cell runs at 4/5 of it.
"""
import argparse
import gc
import time

import torch

from bench_gpu import harness


def one(workload, legs, seed, seconds):
    cell = harness.Cell(workload, seed, "cuda", legs=legs)
    with harness.environ(cell.cfg["env"]):
        cell.set_up()
        cell.host_ms = []
        a0 = cell.clock.anchor()
        ticks, _, _, _ = cell.loop(seconds)
        a1 = cell.clock.anchor()
    landed = cell.clock.host_times([m for _, _, m in ticks], a0, a1)
    lat = [(h - due) * 1e3 for (_, due, _), h in zip(ticks, landed)]
    q = len(lat) // 4
    growth = sorted(lat[-q:])[q // 2] - sorted(lat[:q])[q // 2]
    s = sorted(lat)
    interval = float(cell.traffic.get("interval_ms", 10))
    row = (f"legs {legs} ticks {len(lat)} median_ms {harness.percentile(s, 50):.3f} "
           f"p95_ms {harness.percentile(s, 95):.3f} max_ms {s[-1]:.3f} "
           f"late {sum(x > interval for x in lat)} growth_ms {growth:.3f} "
           f"dispatch_ms {sum(cell.host_ms) / len(cell.host_ms):.3f}")
    del cell
    gc.collect()
    torch.cuda.empty_cache()
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--legs", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seed", type=int, default=1)
    args = ap.parse_args()
    for legs in args.legs:
        t0 = time.perf_counter()
        print(one(args.workload, legs, args.seed, args.seconds),
              f"run_s {time.perf_counter() - t0:.1f}", flush=True)


if __name__ == "__main__":
    main()
