"""BENCHMARK.json against the benchmark's contract: keys, names and units
in their characters, limits, each cell's metrics, and the files that the
harness finds by name."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "bench_gpu"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32 and all(_line(w) for w in bench["command"])
    assert not any(w.startswith("/") or ".." in w for w in bench["command"])
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51


def test_configs(bench):
    used = {w["config"] for w in bench["workloads"]}
    files = [c["file"] for c in bench["configs"]]
    assert len(set(files)) == len(files) and 1 <= len(files) <= 24
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("bench_gpu/") and (ROOT / c["file"]).is_file()
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert (BENCH / "systems" / f"{cfg['system']}.py").is_file()
        assert (BENCH / "reference" / "systems" / f"{cfg['system']}.py").is_file()
        assert set(cfg.get("reduced_why", {})) == set(c["reduced"]), c["name"]
        assert {"out_gap", "state_gap", "nonfinite"} <= set(cfg["limits"])


def test_cells(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert len(set(names)) == len(names) and 1 <= len(names) <= 24
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in bench["workloads"]) <= max(1, len(names) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()


def _reports(metric, cell):
    return cell in metric.get("workloads", [cell])


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    layer = bench["per_layer"]
    names = [m["name"] for m in bench["end_to_end"] + layer]
    assert len(set(names)) == len(names)
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16 and 1 <= len(layer) <= 128
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", [])) <= cells
    layers = {}
    for m in layer:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e and _line(m["layer"])
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        for cell in m.get("workloads", cells):
            assert cell in cells and _reports(e2e[m["moves"]], cell), (m["name"], cell)
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for m in bench["end_to_end"] + layer:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_every_cell_reports_enough(bench):
    for w in bench["workloads"]:
        cell = w["name"]
        e2e = [m["name"] for m in bench["end_to_end"] if _reports(m, cell)]
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        layer = [m for m in bench["per_layer"]
                 if cell in m.get("workloads", []) or ("workloads" not in m and m["moves"] in e2e)]
        assert layer, cell


def test_files_are_named_from_names():
    for p in BENCH.rglob("*"):
        if "out" in p.relative_to(BENCH).parts or "__pycache__" in p.parts:
            continue
        assert PATH.match(p.relative_to(ROOT).as_posix()), p
