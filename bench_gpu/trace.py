"""The traced window: ``torch.profiler`` over a few ticks, reduced from its
Chrome trace to what the per-layer readers and the breakdown need.

Times are the profiler's, in microseconds on one clock for the host and
the device. The window runs from the start of the first tick's dispatch
(the harness's ``bench.tick`` span) to the end of the last device
activity; the device is busy where a kernel, a copy or a memset runs
(their union), idle elsewhere in the window. A tick's span runs from the
start of its dispatch to the end of the last device activity that its
dispatch launched (joined by the profiler's correlation ids): its landing.

A kernel is cuBLAS's, PyTorch's or hand-written, by rules fixed here and
never read from the program: PyTorch's kernels live in its namespaces
(``at::``, ``at_cuda_detail::``, ``c10::``), cuBLAS's match ``CUBLAS``, and
every other kernel is hand-written: the program's CUDA kernels today, and
any kernel a later change adds.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import re

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
CUBLAS = re.compile(r"gemm|gemv|cublas|cutlass|xmma|splitk", re.I)
PYTORCH = ("at::", "at_cuda_detail::", "c10::")
INF = float("inf")


def kernel_base(name: str) -> str:
    """A demangled kernel name's qualified identifier: ``void
    at::native::foo<4>(...)`` -> ``at::native::foo``."""
    name = name.strip()
    if name.startswith("void "):
        name = name[5:]
    return re.split(r"[<(]", name, 1)[0].strip()


def kind(name: str) -> str:
    """``pytorch``, ``cublas`` or ``hand``: who wrote a kernel."""
    if kernel_base(name).startswith(PYTORCH):
        return "pytorch"
    return "cublas" if CUBLAS.search(name) else "hand"


@dataclasses.dataclass
class Trace:
    ticks: int
    device: list          # (name, cat, start_us, dur_us), sorted by start
    host: list            # (name, cat, start_us, dur_us)
    launches: list = dataclasses.field(default_factory=list)  # (start_us, correlation)
    device_end: dict = dataclasses.field(default_factory=dict)  # correlation -> end_us

    @classmethod
    def from_chrome(cls, path, ticks: int):
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        device, host, launches, device_end = [], [], [], {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = str(e.get("cat", "")).lower()
            row = (e.get("name", ""), cat, float(e["ts"]), float(e.get("dur", 0.0)))
            corr = (e.get("args") or {}).get("correlation")
            if cat in DEVICE_CATS:
                device.append(row)
                if corr is not None:
                    device_end[corr] = max(device_end.get(corr, 0.0), row[2] + row[3])
            elif cat in HOST_CATS:
                host.append(row)
            elif cat in LAUNCH_CATS and corr is not None:
                launches.append((row[2], corr))
        device.sort(key=lambda r: r[2])
        launches.sort()
        return cls(ticks, device, host, launches, device_end)

    # -- the window ------------------------------------------------------------
    def window_us(self):
        """(start, end); empty where nothing ran on the device."""
        starts = [s for n, c, s, d in self.host if c == "user_annotation" and n == "bench.tick"]
        if not starts or not self.device:
            return 0.0, 0.0
        return min(starts), max(s + d for _, _, s, d in self.device)

    def busy_intervals(self, lo=None, hi=None):
        """The union of the device's activity, clipped to [lo, hi] (the
        window by default)."""
        if lo is None:
            lo, hi = self.window_us()
        merged = []
        for _, _, s, d in self.device:
            a, b = max(s, lo), min(s + d, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def window_s(self) -> float:
        lo, hi = self.window_us()
        return (hi - lo) * 1e-6

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    # -- the ticks' spans -----------------------------------------------------------
    def tick_spans(self):
        """[start, landing] of each tick whose dispatch launched device
        work that the trace joins to it, in the order dispatched."""
        spans = []
        for name, cat, s, d in self.host:
            if cat != "user_annotation" or name != "bench.tick":
                continue
            i, j = bisect.bisect_left(self.launches, (s,)), bisect.bisect_right(self.launches, (s + d, INF))
            ends = [self.device_end[c] for _, c in self.launches[i:j] if c in self.device_end]
            if ends:
                spans.append((s, max(ends)))
        return sorted(spans)

    def tick_idle_share(self):
        """The share of the ticks' spans (their union) in which the device
        runs nothing; None where no span was found."""
        merged = []
        for a, b in self.tick_spans():
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        total = sum(b - a for a, b in merged)
        if total <= 0:
            return None
        busy = sum(y - x for a, b in merged for x, y in self.busy_intervals(a, b))
        return 1.0 - busy / total

    # -- kernels -----------------------------------------------------------------
    def kernels(self):
        return [r for r in self.device if r[1] == "kernel"]

    def kernel_us(self, who: str) -> float:
        """Device us in the kernels of ``kind`` ``who``."""
        return sum(d for n, _, _, d in self.kernels() if kind(n) == who)

    def launches_of(self, base: str):
        """Durations (us) of the launches of the kernel named ``base``."""
        return [d for n, _, _, d in self.kernels() if kernel_base(n) == base]

    # -- the breakdown -------------------------------------------------------------
    def device_ops(self, n=10):
        tot = {}
        for name, _, _, d in self.device:
            key = kernel_base(name) or name
            tot[key] = tot.get(key, 0.0) + d
        return [[k, v * 1e-6] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]

    def host_at(self, t_us: float) -> str:
        """What the host was doing at ``t_us``: the innermost harness span
        and the innermost operator, as ``span/op``."""
        span = op = None
        for name, cat, s, d in self.host:
            if s <= t_us <= s + d:
                if cat == "user_annotation":
                    if span is None or s >= span[1]:
                        span = (name, s)
                elif op is None or d <= op[1]:
                    op = (name, d)
        parts = [p[0] for p in (span, op) if p is not None]
        return "/".join(parts) if parts else "host idle"

    def idle_gaps(self, n=10):
        lo, hi = self.window_us()
        busy = self.busy_intervals()
        edges = [lo] + [x for iv in busy for x in iv] + [hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges) - 1, 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.host_at((a + b) / 2), (b - a) * 1e-6] for a, b in gaps[:n]]

    def summary(self) -> str:
        """The full table: every device operation by total time."""
        rows = {}
        for name, cat, _, d in self.device:
            r = rows.setdefault((cat, name), [0, 0.0])
            r[0] += 1
            r[1] += d
        lines = [f"ticks {self.ticks}  window_s {self.window_s():.6f}  busy_s {self.busy_s():.6f}",
                 f"{'kind':8s} {'calls':>7s} {'total_ms':>10s} {'mean_us':>9s}  name"]
        for (cat, name), (cnt, tot) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
            who = kind(name) if cat == "kernel" else cat
            lines.append(f"{who:8s} {cnt:7d} {tot / 1e3:10.4f} {tot / cnt:9.2f}  {name[:160]}")
        lines.append("idle gaps (host activity, s):")
        lines += [f"  {s:.6f}  {name}" for name, s in self.idle_gaps(25)]
        return "\n".join(lines) + "\n"
