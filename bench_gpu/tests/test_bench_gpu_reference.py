"""The frozen reference against the port's CPU path at a few legs, free
running from the initial state, both configurations."""
import json
from pathlib import Path

import pytest
import torch

from bench_gpu import files, harness, judge, signals
from bench_gpu.reference import graphs, ops

ROOT = Path(__file__).resolve().parents[2]
LEGS, TICKS = 16, 24


def _cfg(name):
    return json.loads((ROOT / "bench_gpu" / "configs" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["flagship48k", "pcmu_bridge"])
def test_reference_follows_the_port(name):
    cfg = _cfg(name)
    mod = files.by_name("systems", cfg["system"], "system")
    ref = graphs.system(cfg)
    g = torch.Generator().manual_seed(7)
    with harness.environ(cfg["env"]):
        port = mod.Port(cfg, LEGS, "cpu")
        st = ref.init_state(cfg, LEGS, "cpu")
        pr = ops.Products("cpu")
        rows = torch.arange(LEGS)
        gaps = judge.Gaps()
        far = 0.2 * torch.randn(LEGS, 480 * TICKS, generator=g)
        mic = 0.05 * torch.randn(LEGS, 480 * TICKS, generator=g) + 0.5 * torch.roll(far, 400, 1)
        for t in range(TICKS):
            sl = slice(480 * t, 480 * (t + 1))
            if cfg["system"] == "flagship":
                ins = {"mic": mic[:, sl].contiguous(), "spk_ref": far[:, sl].contiguous()}
            else:
                x8 = 0.2 * torch.randn(LEGS, 80, generator=g)
                ins = {"codes": ops.ulaw_encode(ops.float_to_pcm16(x8)).to(torch.uint8),
                       "mic": mic[:, sl].contiguous()}
            got = port.tick(ins)
            st, want, _ = ref.tick(pr, cfg, st, ins, LEGS, rows)
            gaps.outputs(got, want)
            gaps.state(port.state, st)
    numbers = gaps.numbers(0)
    ok, table = judge.verdict(numbers, cfg["limits"])
    assert ok, table


def test_an_unknown_system_or_signal_kind_is_an_error():
    with pytest.raises(ValueError, match="unknown reference system"):
        graphs.system({"system": "no_such_system"})
    with pytest.raises(ValueError, match="unknown signal kind"):
        signals.make({"ring_ticks": 2, "signals": {"x": {"kind": "no_such_kind"}}}, 4, 1, "cpu")


def test_the_e2e_system_checks_what_its_graph_fixes():
    cfg = _cfg("pcmu_bridge")
    mod = files.by_name("systems", cfg["system"], "system")
    with harness.environ(cfg["env"]), pytest.raises(ValueError, match="conf_size"):
        mod.Port(dict(cfg, conf_size=16), 16, "cpu")
