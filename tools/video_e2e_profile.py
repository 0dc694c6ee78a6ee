#!/usr/bin/env python3
"""Where the host time of phase 12b's ticks goes: chip_smoke.py's
``VideoE2EBench`` (4 legs of the dummy codec at 320x240, 15 fps,
self-looped over localhost UDP, a tick a frame).

Prints, in this order:

- the host: CPU count, model, load average;
- the per-call cost of the calls a packet makes: ``sendto``, ``recvfrom``
  and ``recv`` of 1,384-byte datagrams on a self-looped localhost socket,
  a bare system call, and building and packing an ``RtpPacket``;
- for each ``--depth`` (the bench's pipeline depth: 0 publishes on the
  ticker's thread, more on its publish worker), ``--runs`` paced runs of
  ``--seconds`` (after 1 s of warm-up): each tick's host
  time (min, median, 90th percentile, max, ticks over the interval), the
  time of the stream's push (on the ticker's thread at depth 0, on the
  publish worker above), the ticker's pull / dispatch / publish means, and the garbage collector's
  passes in the window with their time;
- ``--profile`` unpaced ticks under cProfile, the top rows by own time.

    python3 tools/video_e2e_profile.py [--runs 2] [--depth 0 2] [--profile 45]

``--device cpu`` rehearses it without a card.
"""
import argparse
import cProfile
import gc
import io
import os
import pstats
import socket
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def host_line():
    model = "unknown"
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    return (f"host: {os.cpu_count()} CPUs ({model}), load average "
            f"{os.getloadavg()}, threads in this process {threading.active_count()}")


def per_call_us(n=3360, size=1384, burst=84):
    """Mean µs a call of sendto, recvfrom, recv, a bare system call and an
    RtpPacket pack, over ``n`` calls in bursts of ``burst`` datagrams."""
    from mediastreamer2_tpu_torch.net.rtp import RtpPacket
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.bind(("127.0.0.1", 0))
    s.setblocking(False)
    dst = s.getsockname()
    data = b"\x00" * size
    t_send = 0.0
    t_recv, got = {}, {}
    for recv in (s.recvfrom, s.recv):
        t_recv[recv.__name__] = got[recv.__name__] = 0
        for _ in range(n // burst):
            t0 = time.perf_counter()
            for _ in range(burst):
                s.sendto(data, dst)
            t1 = time.perf_counter()
            while True:
                try:
                    recv(65536)
                    got[recv.__name__] += 1
                except BlockingIOError:
                    break
            t_send += t1 - t0
            t_recv[recv.__name__] += time.perf_counter() - t1
    s.close()
    t0 = time.perf_counter()
    for _ in range(n):
        os.getppid()
    t_sys = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(n):
        RtpPacket(96, i & 0xFFFF, 0, 1, data, False).pack()
    t_pack = time.perf_counter() - t0
    out = {"sendto": 1e6 * t_send / (2 * n)}
    out.update({k: 1e6 * t / max(got[k], 1) for k, t in t_recv.items()})
    return {**out, "received": f"{sum(got.values())}/{2 * n}", "getppid": 1e6 * t_sys / n,
            "RtpPacket.pack": 1e6 * t_pack / n}


def bench(dev, size, fps, legs, depth):
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.models.video_e2e_bench import VideoE2EBench
    return VideoE2EBench(Factory(), legs, codec=None, width=size[0], height=size[1], fps=fps,
                         pipeline_depth=depth, frame_tick=True, device=dev)


def paced(dev, card, seconds, size, fps, legs, depth):
    b = bench(dev, size, fps, legs, depth)
    tk = b.vs.ticker
    dts, gcs = [], []
    record = tk.stats.record

    def timed(dt_ms, interval_ms):
        dts.append(dt_ms)
        record(dt_ms, interval_ms)

    def on_gc(phase, info, t=[0.0]):
        if phase == "start":
            t[0] = time.perf_counter()
        else:
            gcs.append((info["generation"], 1e3 * (time.perf_counter() - t[0])))
    pushes = []
    push = tk._io_push

    def timed_push(tick, ext_out):
        t0 = time.perf_counter()
        push(tick, ext_out)
        pushes.append(1e3 * (time.perf_counter() - t0))
    tk.stats.record = timed
    tk._io_push = timed_push
    tk.realtime = True
    tk.warm_up()
    tk.run(int(fps))
    tk.drain()
    del dts[:], pushes[:]
    n0 = tk.stats.ticks
    gc.callbacks.append(on_gc)
    try:
        res = b.run(seconds=seconds, paced=True, warmup_seconds=0)
    finally:
        gc.callbacks.remove(on_gc)
    n = tk.stats.ticks - n0
    d, p = np.array(dts), np.array(pushes)
    ph = tk.phase_ms
    per = {k: round(ph[k] / tk.stats.ticks, 3) for k in ("queue", "pull", "dispatch", "publish")}
    print(f"12b paced, a tick a frame ({tk.interval_ms:.3f} ms), {legs} legs, pipeline depth "
          f"{depth}, {seconds:g} s: "
          f"{n} ticks, tick host ms min {d.min():.3f} median {np.median(d):.3f} p90 "
          f"{np.percentile(d, 90):.3f} max {d.max():.3f}, over the interval "
          f"{int((d > tk.interval_ms).sum())}; the stream's push (RTP out and in) ms median "
          f"{np.median(p):.3f} p90 {np.percentile(p, 90):.3f} max {p.max():.3f}; late ticks {res.late_ticks}, fps min "
          f"{res.fps_received_min:.3f}; ticker means ms/tick (whole run) {per}; gc passes "
          f"{len(gcs)} (gen2 {sum(g == 2 for g, _ in gcs)}), {sum(m for _, m in gcs):.3f} ms, "
          f"longest {max((m for _, m in gcs), default=0.0):.3f} ms; passes {res.passes()} "
          f"[{card}]", flush=True)
    b.close()


def profiled(dev, card, ticks, size, fps, legs, top):
    b = bench(dev, size, fps, legs, 0)
    tk = b.vs.ticker
    tk.realtime = False
    tk.warm_up()
    tk.run(int(fps))
    tk.drain()
    pr = cProfile.Profile()
    t0 = time.perf_counter()
    pr.enable()
    tk.run(ticks)
    tk.drain()
    pr.disable()
    wall = time.perf_counter() - t0
    out = io.StringIO()
    pstats.Stats(pr, stream=out).sort_stats("tottime").print_stats(top)
    print(f"12b unpaced under cProfile, {ticks} ticks: {1e3 * wall / ticks:.3f} ms a tick "
          f"[{card}]\n{out.getvalue()}", flush=True)
    b.close()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seconds", type=float, default=chip_smoke.VIDEO_E2E_SECONDS)
    ap.add_argument("--profile", type=int, default=45)
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--depth", type=int, nargs="+", default=[0, chip_smoke.VIDEO_E2E_DEPTH])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("video_e2e_profile: no CUDA device")
    card = chip_smoke.card_line() if dev.type == "cuda" else "cpu"
    size, fps, legs = chip_smoke.VIDEO_E2E_SIZE, chip_smoke.VIDEO_E2E_FPS, chip_smoke.VIDEO_E2E_LEGS
    print(host_line(), flush=True)
    print(f"per call, µs: {per_call_us()} [{card}]", flush=True)
    for _ in range(args.runs):
        for depth in args.depth:
            paced(dev, card, args.seconds, size, fps, legs, depth)
    profiled(dev, card, args.profile, size, fps, legs, args.top)


if __name__ == "__main__":
    main()
