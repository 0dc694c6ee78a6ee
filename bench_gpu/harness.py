"""One run of one cell: set-up, the measured window, the traced window, the
comparison with the reference, the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric is found by its name in ``BENCHMARK.json``:

* ``configs/<config>.json`` (the ``file`` of the configuration): the sizes,
  the environment the program reads, the system and the limits of the
  comparison; the system is ``systems/<system>.py`` (the program, built and
  ticked) and its reference ``reference/systems/<system>.py``;
* ``traffic/<traffic>.json``: legs, the loop, the signals, each of a kind
  ``signals/<kind>.py`` (``signals/__init__.py``);
* ``metrics/<metric>.py``: a per-layer reader, ``read(ctx)`` returning a
  number or None, and optionally ``probe(ctx)``, a context manager held
  around the traced ticks.

A tick is dispatched by one call into the system and a copy of its
read-back outputs into pinned host memory; an event after the copy marks
when they landed. At most ``in_flight`` ticks are outstanding. A closed
loop dispatches the next tick as soon as one is free; an open loop
dispatches tick i when it is due, ``interval_ms`` after tick i-1 was due,
whatever the ticks before it did.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import random
import sys
import time
import types
from collections import deque
from pathlib import Path

import torch

from bench_gpu import files, judge, signals
from bench_gpu.files import BENCH_DIR
from bench_gpu.reference import graphs, ops

START_TICKS = 3         # ticks judged from the initial state, in set-up
WARM_TICKS = 5          # further set-up ticks, in the window's own loop, just before it
GROUPS_SAMPLED = 16     # conference groups the reference follows
JUDGED_TICK = (2, 30)   # the judged window tick, drawn from the seed in this range
FORBIDDEN = ("jax", "jaxlib", "flax", "mediastreamer2_tpu")


# -- files found by name -----------------------------------------------------------
def manifest() -> dict:
    with open(BENCH_DIR.parent / "BENCHMARK.json") as f:
        return json.load(f)


def cell_spec(workload: str):
    """(cell, config, traffic, end-to-end metrics, per-layer metrics) of
    one workload."""
    m = manifest()
    cell = next((w for w in m["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    entry = next(c for c in m["configs"] if c["name"] == cell["config"])
    with open(BENCH_DIR.parent / entry["file"]) as f:
        cfg = json.load(f)
    with open(BENCH_DIR / "traffic" / f"{cell['traffic']}.json") as f:
        traffic = json.load(f)
    e2e = [x for x in m["end_to_end"] if workload in x.get("workloads", [workload])]
    names = {x["name"] for x in e2e}
    layer = [x for x in m["per_layer"]
             if workload in x["workloads"] or ("workloads" not in x and x["moves"] in names)]
    return cell, cfg, traffic, e2e, layer


@contextlib.contextmanager
def environ(env: dict):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# -- the system, or the reference in its place --------------------------------------
class Control:
    """The reference put in the program's place, on the run's device, with
    every product's operands rounded to TF32: the precision below the
    configuration's float32 products."""

    def __init__(self, cfg, legs, device, readback):
        self.cfg, self.legs, self.readback = cfg, legs, readback
        self.pr = ops.Products(device, tf32=True)
        self.ref = graphs.system(cfg)
        self.rows = torch.arange(legs, device=device)
        self.state = self.ref.init_state(cfg, legs, device)
        self.device = torch.device(device)

    def tick(self, ins):
        ins = {k: v.to(self.device, non_blocking=True) for k, v in ins.items()}
        self.state, outs, _ = self.ref.tick(self.pr, self.cfg, self.state, ins, self.legs,
                                            self.rows)
        return outs


def rows_of(tree, idx, batch):
    """The rows ``idx`` of every [batch, ...] tensor of a state tree, and
    copies of the rest (scalars), as new tensors on the same device."""
    if isinstance(tree, dict):
        return {k: rows_of(v, idx, batch) for k, v in tree.items()}
    if tree.dim() and tree.shape[0] == batch:
        return tree.index_select(0, idx)
    return tree.clone()


def rows_into(tree, idx, batch, out):
    """``rows_of`` into the tensors of ``out`` (a tree ``rows_of`` made),
    so that gathering in the window allocates nothing: an allocation there
    may wait for the device."""
    for k, v in tree.items():
        if isinstance(v, dict):
            rows_into(v, idx, batch, out[k])
        elif v.dim() and v.shape[0] == batch:
            torch.index_select(v, 0, idx, out=out[k])
        else:
            out[k].copy_(v)
    return out


def clone(tree):
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    return tree.clone()


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    return tree.cpu()


def nonfinite(tree) -> int:
    if isinstance(tree, dict):
        return sum(nonfinite(v) for v in tree.values())
    return int((~torch.isfinite(tree)).sum()) if tree.is_floating_point() else 0


def tree_bytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


class Clock:
    """When a tick's outputs landed: an event after its copies, read on the
    device's clock and mapped onto the host's by two anchors (an event
    recorded on an idle stream at a known host time, before and after). On
    the CPU, where a tick returns when done, the host's clock."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"

    def anchor(self):
        if not self.cuda:
            return None
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        h = time.perf_counter()
        ev.record()
        ev.synchronize()
        return h, ev

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, mark):
        if self.cuda:
            mark.synchronize()

    def host_times(self, marks, a0, a1):
        if not self.cuda:
            return list(marks)
        (h0, e0), (h1, e1) = a0, a1
        dev = e0.elapsed_time(e1) / 1e3
        scale = (h1 - h0) / dev if dev > 0 else 1.0
        return [h0 + e0.elapsed_time(m) / 1e3 * scale for m in marks]


class Cell:
    """The state of one run."""

    def __init__(self, workload, seed, device, variant="port", legs=None):
        self.workload, self.seed = workload, int(seed)
        self.cell, self.cfg, self.traffic, self.e2e, self.layer = cell_spec(workload)
        self.device = torch.device(device)
        self.legs = int(legs or self.traffic["legs"])
        self.k = int(self.cfg["conf_size"])     # the legs of a conference group
        if self.legs % self.k:
            raise ValueError(f"{self.legs} legs do not make groups of {self.k}")
        self.variant = variant
        self.clock = Clock(self.device)
        self.depth = int(self.traffic["in_flight"])
        self.t = 0                      # ticks dispatched so far
        self.host_ms = []              # host ms of each dispatch
        self.host_start = []           # host clock at each dispatch's start
        self.notes = []                # diagnostics for standard error
        self.slots = None
        self.annotate = False
        rng = random.Random(self.seed)
        groups = self.legs // self.k
        inner = range(1, groups - 1)
        pick = {0, groups - 1} | set(rng.sample(inner, min(GROUPS_SAMPLED - 2, len(inner))))
        self.sample = [g * self.k + j for g in sorted(pick) for j in range(self.k)]
        self.sample_idx = torch.as_tensor(self.sample, dtype=torch.long, device=self.device)
        self.judged_offset = rng.randrange(*JUDGED_TICK)

    # -- set-up ------------------------------------------------------------------------
    def build(self):
        mod = files.by_name("systems", self.cfg["system"], "system")
        graphs.system(self.cfg)         # a system without its reference is an error
        if self.variant == "control":
            self.system = Control(self.cfg, self.legs, self.device, mod.Port.readback)
        else:
            self.system = mod.Port(self.cfg, self.legs, self.device)
        self.rings = signals.make(self.traffic, self.legs, self.seed, self.device)
        self.R = int(self.traffic["ring_ticks"])

    def inputs(self, t):
        return {k: ring[t % self.R] for k, ring in self.rings.items()}

    def sample_inputs(self, t):
        return {k: ring[t % self.R].index_select(0, self.sample_idx.to(ring.device)).cpu()
                for k, ring in self.rings.items()}

    def _span(self, name):
        return torch.profiler.record_function(name) if self.annotate else contextlib.nullcontext()

    def dispatch(self):
        """Dispatch tick ``self.t``: (tick, its outputs on the device, the
        mark of its read-back copies)."""
        t = self.t
        with self._span("bench.tick"):
            h = time.perf_counter()
            self.host_start.append(h)
            outs = self.system.tick(self.inputs(t))
            if self.slots is None:
                pin = self.device.type == "cuda"
                self.slots = [{n: torch.empty(outs[n].shape, dtype=outs[n].dtype, pin_memory=pin)
                               for n in self.system.readback} for _ in range(self.depth + 1)]
            slot = self.slots[t % (self.depth + 1)]
            for n in self.system.readback:
                slot[n].copy_(outs[n], non_blocking=True)
            mark = self.clock.mark()
            self.host_ms.append((time.perf_counter() - h) * 1e3)
        self.t += 1
        return t, outs, mark

    def readback_rows(self, t):
        slot = self.slots[t % (self.depth + 1)]
        return {n: slot[n][self.sample].clone() for n in self.system.readback}

    def extra_rows(self, outs, into=None):
        """Device copies of the sampled rows of the outputs not read back
        (into the tensors of ``into``, where given)."""
        extra = {n: v for n, v in outs.items() if n not in self.system.readback}
        if into is None:
            return rows_of(extra, self.sample_idx, self.legs)
        return rows_into(extra, self.sample_idx, self.legs, into)

    def set_up(self):
        """Build, make the inputs, run the start ticks (kept for the
        comparison) and the warm-up ticks."""
        self.build()
        self.start = {"ins": [], "outs": []}
        for _ in range(START_TICKS):
            self.start["ins"].append(self.sample_inputs(self.t))
            t, outs, mark = self.dispatch()
            extra = self.extra_rows(outs)
            self.clock.wait(mark)
            self.start["outs"].append({**self.readback_rows(t), **to_cpu(extra)})
        rows = rows_of(self.system.state, self.sample_idx, self.legs)
        self.start["state"] = to_cpu(rows)
        # the judged window tick's rows land in buffers made now
        self.judge_bufs = {"pre": clone(rows), "post": clone(rows), "outs": clone(extra)}
        gc.collect()
        self.loop(n_ticks=WARM_TICKS)
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    # -- the loops -------------------------------------------------------------------------
    def loop(self, seconds: float = None, judge_tick=None, n_ticks=None):
        """Dispatch ticks in the traffic's loop for ``seconds`` (or, in a
        closed loop, ``n_ticks`` ticks), then wait for the last. Returns
        (ticks [(tick, due or None, mark)], host start, host end, the judged
        tick's record or None); the judged tick's state rows are gathered
        on the device, between its neighbours' launches."""
        paced = self.traffic["loop"] == "open"
        interval = float(self.traffic.get("interval_ms", 10)) / 1e3
        inflight = deque()
        ticks, judged = [], None

        def pop():
            t, due, mark = inflight.popleft()
            with self._span("bench.wait"):
                self.clock.wait(mark)
            if judged is not None and t == judged["tick"]:
                judged["outs"].update(self.readback_rows(t))
            ticks.append((t, due, mark))

        t0 = time.perf_counter() + (0.002 if paced else 0.0)
        t_end = t0 + (seconds or 0.0)
        i = 0
        while True:
            if n_ticks is not None:
                if i >= n_ticks:
                    break
            elif (t0 + i * interval if paced else time.perf_counter()) >= t_end:
                break
            while len(inflight) >= self.depth:
                pop()
            due = t0 + i * interval if paced else None
            if paced:
                # spin, not sleep: a sleeping thread on a loaded host wakes
                # milliseconds late, and the schedule would slip with it
                with self._span("bench.spin"):
                    while time.perf_counter() < due:
                        pass
            if judge_tick is not None and self.t == judge_tick:
                judged = {"tick": self.t, "pre": rows_into(
                    self.system.state, self.sample_idx, self.legs, self.judge_bufs["pre"])}
            t, outs, mark = self.dispatch()
            if judged is not None and t == judged["tick"]:
                judged["post"] = rows_into(self.system.state, self.sample_idx, self.legs,
                                           self.judge_bufs["post"])
                judged["outs"] = self.extra_rows(outs, self.judge_bufs["outs"])
            inflight.append((t, due, mark))
            i += 1
        while inflight:
            pop()
        return ticks, t0, t_end, judged

    # -- the whole run -----------------------------------------------------------------------
    def run(self, seconds, trace, t_process0, out_dir: Path):
        with environ(self.cfg["env"]):
            return self._run(seconds, trace, t_process0, out_dir)

    def _run(self, seconds, trace, t_process0, out_dir):
        self.set_up()           # ends with the warm ticks, the device synchronized
        cuda = self.device.type == "cuda"
        gc.disable()
        try:
            a0 = self.clock.anchor()
            setup_s = time.perf_counter() - t_process0
            self.host_ms, self.host_start = [], []
            window_t0 = self.t
            ticks, _, t_end, judged = self.loop(seconds, window_t0 + self.judged_offset)
            if judged is None:          # the window closed first: judge the next tick
                judged = self.loop(judge_tick=self.t, n_ticks=1)[3]
            a1 = self.clock.anchor()
        finally:
            gc.enable()
        landed = self.clock.host_times([m for _, _, m in ticks], a0, a1)
        host_ms = self.host_ms[:len(ticks)]
        e2e, done = self._window_metrics(ticks, landed, host_ms, t_end, seconds, out_dir)
        e2e["setup_s"] = setup_s
        judged = {"ins": self.sample_inputs(judged["tick"]), "outs": to_cpu(judged["outs"]),
                  "pre": to_cpu(judged["pre"]), "post": to_cpu(judged["post"])}
        n_bad = nonfinite(self.system.state) + sum(
            nonfinite(s) for s in self.slots[(self.t - 1) % (self.depth + 1)].values())
        peak = torch.cuda.max_memory_allocated(self.device) if cuda else 0
        device = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(self.device) if cuda else "cpu",
                  "count": int(self.cell["chips"]), "memory_peak_bytes": int(peak)}
        breakdown = None
        if trace:
            layer, tr = self.traced(sum(host_ms) / len(ticks), seconds / max(done, 1), out_dir)
            metrics = {m["name"]: {"value": layer[m["name"]], "unit": m["unit"]}
                       for m in self.layer if layer.get(m["name"]) is not None}
            device["busy_s"], device["window_s"] = tr.busy_s(), tr.window_s()
            breakdown = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
        else:
            metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                       for m in self.e2e if m["name"] in e2e}
        # the program's state and the inputs are freed before the reference runs
        del self.system, self.rings
        self.slots = None
        if cuda:
            torch.cuda.empty_cache()
        numbers, worst = judge.compare(self.cfg, self.legs, self.sample, self.start, judged, n_bad)
        self.notes += [f"largest {k}: {v!r} at {where}" for k, (v, where) in worst.items()]
        correct, table = judge.verdict(numbers, self.cfg["limits"])
        result = {"correct": correct, "attempted": len(ticks), "failed": 0, "metrics": metrics,
                  "device": device}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["compared"] = table
        return result

    def _window_metrics(self, ticks, landed, host_ms, t_end, seconds, out_dir):
        """({end-to-end metric: value}, ticks landed in the window), and
        the window's diagnostics in ``notes`` (and, for an open loop, each
        tick's numbers in ``out_dir/<cell>.ticks.json``)."""
        longest = sorted(range(len(host_ms)), key=lambda i: -host_ms[i])[:5]
        self.notes.append(f"window: {len(ticks)} ticks; host ms a dispatch (p50 p95 max) "
                          f"{quantiles(host_ms)}; longest (tick: ms) "
                          + ", ".join(f"{i}: {host_ms[i]:.3f}" for i in longest))
        if self.traffic["loop"] != "open":
            done = sum(1 for h in landed if h <= t_end)
            return {"realtime_legs": self.legs * done / seconds / 100.0}, done
        interval_ms = float(self.traffic.get("interval_ms", 10))
        lat = [(h - due) * 1e3 for (_, due, _), h in zip(ticks, landed)]
        late = [(h - due) * 1e3 for (_, due, _), h in zip(ticks, self.host_start)]
        tenth = max(1, len(lat) // 10)
        self.notes += [
            "tick latency ms by tenth of the window (p50 p95 max): "
            + "; ".join(quantiles(lat[i:i + tenth]) for i in range(0, len(lat), tenth)),
            f"tick latency ms (p50 p95 max) {quantiles(lat)}, over {interval_ms:g} ms: "
            f"{sum(x > interval_ms for x in lat)}",
            f"the generator's lateness ms, dispatch start less due (p50 p95 max) "
            f"{quantiles(late)}"]
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{self.workload}.ticks.json").write_text(json.dumps(
            {"latency_ms": lat, "host_ms": host_ms, "late_ms": late}))
        return {"tick_p95_ms": percentile(sorted(lat), 95)}, len(ticks)

    # -- the traced window -------------------------------------------------------------------
    def traced(self, dispatch_ms, tick_s, out_dir: Path):
        from torch.profiler import ProfilerActivity, profile
        from bench_gpu.trace import Trace
        readers = {m["name"]: files.by_name("metrics", m["name"], "per-layer metric")
                   for m in self.layer}
        ctx = types.SimpleNamespace(
            cfg=self.cfg, traffic=self.traffic, legs=self.legs, dispatch_ms=dispatch_ms,
            tick_s=tick_s, probes={}, trace=None,
            state_bytes=tree_bytes(graphs.system(self.cfg).init_state(self.cfg, self.legs, "meta")),
            io_bytes=sum(r[0].numel() * r.element_size() for r in self.rings.values())
            + sum(s.numel() * s.element_size() for s in self.slots[0].values()))
        n = int(self.traffic["trace_ticks"])
        seconds = n * float(self.traffic.get("interval_ms", 10)) / 1e3
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with contextlib.ExitStack() as stack:
            for mod in readers.values():
                if hasattr(mod, "probe"):
                    stack.enter_context(mod.probe(ctx))
            self.annotate = True
            gc.disable()
            try:
                with profile(activities=activities) as prof:
                    if self.traffic["loop"] == "open":
                        ticks = self.loop(seconds)[0]
                    else:
                        ticks = self.loop(n_ticks=n)[0]
            finally:
                gc.enable()
                self.annotate = False
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / f"{self.workload}.trace.json"
        prof.export_chrome_trace(str(path))
        ctx.trace = tr = Trace.from_chrome(path, len(ticks))
        (out_dir / f"{self.workload}.trace.txt").write_text(tr.summary())
        return {name: mod.read(ctx) for name, mod in readers.items()}, tr


def percentile(sorted_values, q):
    """The q-th percentile, linear between the two nearest ranks."""
    n = len(sorted_values)
    x = (n - 1) * q / 100.0
    lo = math.floor(x)
    hi = min(lo + 1, n - 1)
    return sorted_values[lo] + (sorted_values[hi] - sorted_values[lo]) * (x - lo)


def quantiles(values) -> str:
    s = sorted(values)
    return " ".join(f"{percentile(s, q):.3f}" for q in (50, 95)) + f" {s[-1]:.3f}"


def forbidden(module_names):
    """The forbidden top-level names among ``module_names``, each compared
    whole: ``mediastreamer2_tpu_torch`` is not ``mediastreamer2_tpu``."""
    return sorted({m.split(".")[0] for m in module_names} & set(FORBIDDEN))


def forbidden_modules():
    return forbidden(list(sys.modules))


def report(result):
    """The compared numbers on standard error, then the result line."""
    for name, row in result["compared"].items():
        print(f"compared {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)


def main(args, t_process0: float) -> int:
    chips = int(cell_spec(args.workload)[0]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    cell = Cell(args.workload, args.seed, "cuda")
    result = cell.run(args.seconds, bool(args.trace), t_process0, BENCH_DIR / "out")
    for note in cell.notes:
        print(note, file=sys.stderr)
    bad = forbidden_modules()
    if bad:
        print(f"modules that must not load: {bad}", file=sys.stderr)
        return 3
    report(result)
    return 0
