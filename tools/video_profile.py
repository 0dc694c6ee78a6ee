#!/usr/bin/env python3
"""Where the device time of phase 12a's video step goes: ``VideoStreamBatch``
at 1,024 legs (a 640x480 mire sent at 320x240, chip_smoke.py's shape),
``--ticks`` steps of its u8 step under ``torch.profiler`` after a warm-up,
then the CUDA time a tick of each kernel (``key_averages``' device rows,
sorted), the sum, and the device's busy share of the window.

    python3 tools/video_profile.py [--legs 1024] [--ticks 10]

Needs one CUDA card; prints "no device time" where the profiler records
none (the machine's CUPTI may be unavailable).
"""
import argparse
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--legs", type=int, default=chip_smoke.VIDEO_LEGS)
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("video_profile: no CUDA device")
    dev = torch.device("cuda", 0)
    card = chip_smoke.card_line()
    vs = chip_smoke.video_stream(dev, args.legs, chip_smoke.VIDEO_CAM, chip_smoke.VIDEO_OUT,
                                 chip_smoke.VIDEO_FPS)
    tk = vs.ticker
    out = chip_smoke.VIDEO_OUT
    rx = torch.from_numpy(np.full((args.legs, out[1] * 3 // 2, out[0]), 128,
                                  np.uint8)).to(dev)

    def step():
        with tk.on_stream():
            tk.state, o, _ = tk._step(tk.state, tk.params, {"rx_frames": rx})
        return o

    for _ in range(3):
        step()
    tk.sync()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.ticks):
            step()
        tk.sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():          # the kernels themselves, not the aten ops above them
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((dev_us / args.ticks / 1e3, e.count // args.ticks, e.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    if not rows:
        print(f"video profile: no device time recorded [{card}]", flush=True)
        return
    print(f"video profile: {args.legs} legs, {args.ticks} steps, device time a tick "
          f"{total:.3f} ms of {wall_ms / args.ticks:.3f} ms wall (busy "
          f"{100 * total * args.ticks / wall_ms:.1f}%) [{card}]", flush=True)
    for ms, n, key in rows[:args.top]:
        print(f"  {ms:8.3f} ms  x{n:<3d} {key[:110]}", flush=True)


if __name__ == "__main__":
    main()
