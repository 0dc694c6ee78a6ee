"""The comparison that decides ``correct``.

The reference (``reference/systems/<system>.py``) runs on the CPU over whole
conference groups sampled from the batch, fed the same inputs as the
program, in two parts:

* the start: from its own initial state through the first ticks the
  program ran, comparing each tick's outputs and the state after them;
* a tick inside the window: one step from the program's own state before
  that tick (the reference cannot follow 32,768 legs through a thousand
  ticks), comparing its outputs and the state after it.

Numbers, each held to the configuration's ``limits``:

* ``out_gap``: the widest gap of a float output sample from the
  reference's, over the reference's rms across the sampled legs of that
  tick; the largest over the compared ticks;
* ``state_gap``: each float state tensor's rms difference from the
  reference's over the reference's rms, the largest over tensors and
  compared states (bf16 taps differ by rounding flips: the rms counts them);
* ``code_mismatch``: the share of mu-law codes that differ (a graph that
  sends codes);
* ``nonfinite``: non-finite values in the whole batch's final state and
  last outputs, which must be 0.
"""
from __future__ import annotations

import math

import torch

from bench_gpu.reference import graphs, ops


def _rms(x):
    return float(x.double().pow(2).mean().sqrt()) if x.numel() else 0.0


class Gaps:
    def __init__(self):
        self.out_gap = 0.0
        self.state_gap = 0.0
        self.codes = 0
        self.codes_differ = 0
        self.worst = {}         # number -> (value, where)
        self.stage = ""

    def _keep(self, number, value, where):
        if value > self.worst.get(number, (-1.0, ""))[0]:
            self.worst[number] = (value, f"{self.stage}{where}")

    def outputs(self, got: dict, want: dict):
        for name, g in got.items():
            w = want[name]
            if g.shape != w.shape:
                raise ValueError(f"output {name}: shape {tuple(g.shape)}, "
                                 f"reference {tuple(w.shape)}")
            if g.dtype == torch.uint8:
                self.codes += g.numel()
                self.codes_differ += int((g != w.to(torch.uint8)).sum())
            else:
                gap = _nan_high(float((g.double() - w.double()).abs().max()) / max(_rms(w), 1e-30))
                self.out_gap = max(self.out_gap, gap)
                self._keep("out_gap", gap, name)

    def state(self, got: dict, want: dict):
        for node, entry in want.items():
            for key, w in entry.items():
                if not w.is_floating_point():
                    continue
                g = got[node][key]
                if g.shape != w.shape:
                    raise ValueError(f"state {node}.{key}: shape {tuple(g.shape)}, "
                                     f"reference {tuple(w.shape)}")
                d = _rms(g.double() - w.double())
                gap = _nan_high(0.0 if d == 0.0 else d / max(_rms(w), 1e-30))
                self.state_gap = max(self.state_gap, gap)
                self._keep("state_gap", gap, f"{node}.{key}")

    def numbers(self, nonfinite: int) -> dict:
        out = {"out_gap": self.out_gap, "state_gap": self.state_gap}
        if self.codes:
            out["code_mismatch"] = self.codes_differ / self.codes
        out["nonfinite"] = float(nonfinite)
        return out


def _nan_high(x: float) -> float:
    return math.inf if math.isnan(x) else x


def compare(cfg, batch: int, legs, start: dict, window: dict, nonfinite: int):
    """(the compared numbers, where each float number's largest gap was).
    ``start``: {"ins": [per-tick inputs], "outs": [per-tick outputs],
    "state": the program's state after them};
    ``window``: {"ins", "outs", "pre", "post"} of the judged window tick.
    Everything holds the sampled ``legs`` only, on the CPU."""
    pr = ops.Products("cpu")
    ref = graphs.system(cfg)
    rows = torch.as_tensor(legs, dtype=torch.int64)
    gaps = Gaps()
    st = ref.init_state(cfg, len(legs), "cpu")
    for i, (ins, outs) in enumerate(zip(start["ins"], start["outs"])):
        gaps.stage = f"start tick {i}: "
        st, want, _ = ref.tick(pr, cfg, st, ins, batch, rows)
        gaps.outputs(outs, want)
    gaps.stage = "after the start: "
    gaps.state(start["state"], st)
    gaps.stage = "window tick: "
    post, want, _ = ref.tick(pr, cfg, window["pre"], window["ins"], batch, rows)
    gaps.outputs(window["outs"], want)
    gaps.state(window["post"], post)
    return gaps.numbers(nonfinite), gaps.worst


def verdict(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit; a number without a limit fails."""
    table = {k: {"value": v, "limit": limits.get(k)} for k, v in numbers.items()}
    ok = all(row["limit"] is not None and row["value"] <= row["limit"] for row in table.values())
    return ok, table
