"""Configurations, traffic mixes, a system with its reference, a signal
kind and a per-layer metric added as new files and new BENCHMARK.json
entries, with no edit to a file that is there, run as cells of their own."""
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

READER = '''"""Ticks in the traced window."""


def read(ctx):
    return float(ctx.trace.ticks)
'''

# a new system: AGC -> 48k->16k -> mix-minus, no echo canceller
SYSTEM = '''import torch


class Port:
    readback = ("out",)

    def __init__(self, cfg, legs, device):
        from mediastreamer2_tpu_torch import Factory
        from mediastreamer2_tpu_torch.core.block import Format
        from mediastreamer2_tpu_torch.core.graph import GraphBuilder
        g = GraphBuilder(Factory(), batch=legs)
        mic = g.add("ext_source", "mic", fmt=Format(rate=cfg["rate"]))
        g.chain(mic, g.add("volume", "agc"), g.add("resample", "rs", out_rate=cfg["mix_rate"]),
                g.add("conf_mixer", "conf", sorted_groups=True,
                      uniform_group_size=cfg["conf_size"]), g.add("ext_sink", "out"))
        self.cg = g.build()
        self.params = self.cg.init_params(device)
        self.params["agc"]["agc_enabled"] = torch.ones((legs,), dtype=torch.bool, device=device)
        self.params["conf"]["group_id"] = (
            torch.arange(legs, dtype=torch.int32, device=device) // cfg["conf_size"])
        self.state = self.cg.init_state(device)

    def tick(self, ins):
        self.state, out, _ = self.cg.step(self.state, self.params, {"mic": ins["mic"]})
        return {"out": out["out"]}
'''

REFERENCE = '''from bench_gpu.reference import ops


def init_state(cfg, B, device):
    return {"agc": ops.volume_init(B, device),
            "rs": ops.resample_init(B, cfg["rate"], cfg["mix_rate"], device)}


def tick(pr, cfg, st, ins, batch, legs):
    new = {}
    new["agc"], v = ops.volume_step(st["agc"], ins["mic"])
    new["rs"], r = ops.resample_step(pr, st["rs"], v, cfg["rate"], cfg["mix_rate"])
    return new, {"out": ops.mix_minus(r, int(cfg["conf_size"]))}, {}
'''

# a new signal kind: a tone of ``rms`` at ``hz``, each leg at a phase of its own
SINE = '''import math

import torch

from bench_gpu.reference import ops


def make(sig, made, legs, R, randn, device):
    S = ops.tick_samples(int(sig["rate"]))
    phase = randn(legs, 1) * math.pi
    t = torch.arange(R * S, device=device, dtype=torch.float32)[None, :]
    x = math.sqrt(2) * float(sig["rms"]) * torch.sin(2 * math.pi * float(sig["hz"]) * t
                                                     / float(sig["rate"]) + phase)
    return x.reshape(legs, R, S).permute(1, 0, 2).contiguous()
'''


def _digests(root):
    return {p.relative_to(root).as_posix(): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_cell_added_by_files_alone(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    bench = tmp_path / "bench_gpu"
    shutil.copytree(ROOT / "bench_gpu", bench,
                    ignore=shutil.ignore_patterns("out", "__pycache__", "tests"))
    before = _digests(bench)
    manifest = json.loads((tmp_path / "BENCHMARK.json").read_text())

    cfg = json.loads((bench / "configs" / "flagship48k.json").read_text())
    cfg["tail_ms"] = 40
    (bench / "configs" / "flagship40.json").write_text(json.dumps(cfg))
    agc = {"system": "agc_mix", "rate": 48000, "mix_rate": 16000, "conf_size": 4, "env": {},
           "limits": {"out_gap": 1e-4, "state_gap": 1e-4, "nonfinite": 0.0}}
    (bench / "configs" / "agc_mix.json").write_text(json.dumps(agc))
    (bench / "systems" / "agc_mix.py").write_text(SYSTEM)
    (bench / "reference" / "systems" / "agc_mix.py").write_text(REFERENCE)
    (bench / "signals" / "sine.py").write_text(SINE)
    traffic = json.loads((bench / "traffic" / "echo_unpaced.json").read_text())
    traffic.update(legs=16, ring_ticks=4, trace_ticks=3)
    (bench / "traffic" / "echo_tiny.json").write_text(json.dumps(traffic))
    tone = dict(traffic, signals={"mic": {"kind": "sine", "rate": 48000, "rms": 0.1, "hz": 440}})
    (bench / "traffic" / "tone_tiny.json").write_text(json.dumps(tone))
    (bench / "metrics" / "traced_ticks.py").write_text(READER)
    cells = ["flagship40.tiny", "agc_mix.tone"]
    manifest["configs"] += [
        {"name": "flagship40", "source": "test", "reduced": ["tail_ms"],
         "file": "bench_gpu/configs/flagship40.json", "why": "test"},
        {"name": "agc_mix", "source": "test", "reduced": [],
         "file": "bench_gpu/configs/agc_mix.json", "why": "test"}]
    manifest["workloads"] += [
        {"name": "flagship40.tiny", "config": "flagship40", "traffic": "echo_tiny", "chips": 1,
         "why": "test"},
        {"name": "agc_mix.tone", "config": "agc_mix", "traffic": "tone_tiny", "chips": 1,
         "why": "test"}]
    for m in manifest["end_to_end"]:
        if m["name"] == "realtime_legs":
            m["workloads"] += cells
    manifest["per_layer"].append({"name": "traced_ticks", "unit": "ticks", "better": "higher",
                                  "source": "program_counter", "layer": "graph step (host)",
                                  "moves": "realtime_legs", "workloads": cells})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(manifest))

    code = ("import json, time\n"
            "from bench_gpu import harness\n"
            "for cell in ('flagship40.tiny', 'agc_mix.tone'):\n"
            "    for trace in (False, True):\n"
            "        r = harness.Cell(cell, 3, 'cpu').run(0.2, trace, time.perf_counter(),"
            " harness.BENCH_DIR / 'out')\n"
            "        print(json.dumps(r))\n"
            "for variant in ('control',):\n"
            "    r = harness.Cell('agc_mix.tone', 4, 'cpu', variant=variant).run("
            "0.2, False, time.perf_counter(), harness.BENCH_DIR / 'out')\n"
            "    print(json.dumps(r))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), str(ROOT)]))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    runs = [json.loads(line) for line in res.stdout.strip().splitlines()[-5:]]
    for plain, traced in (runs[0:2], runs[2:4]):
        assert plain["correct"] and traced["correct"], (plain["compared"], traced["compared"])
        assert set(plain["metrics"]) == {"realtime_legs", "setup_s"}
        assert traced["metrics"]["traced_ticks"]["value"] == 3.0
    # the new system's reference, put in its place with TF32 products, is told apart
    assert not runs[4]["correct"], runs[4]["compared"]
    after = _digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before
