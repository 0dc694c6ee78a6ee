"""What a run may load: never JAX nor the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's); the
reference loads nothing of the program; without a card a run fails and
prints nothing."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from bench_gpu import harness

ROOT = Path(__file__).resolve().parents[2]


def _python(code, cwd=ROOT, extra_path=()):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(cwd), *map(str, extra_path)])
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_forbidden_compares_whole_top_level_names():
    allowed = ["mediastreamer2_tpu_torch", "mediastreamer2_tpu_torch.ops.kernels", "jaxtyping",
               "torch", "flaxen.x"]
    assert harness.forbidden(allowed) == []
    assert harness.forbidden(allowed + ["mediastreamer2_tpu.core.graph", "jax._src"]) == [
        "jax", "mediastreamer2_tpu"]


def test_a_whole_run_loads_no_jax():
    code = ("import sys, time\n"
            "from bench_gpu import harness\n"
            "r = harness.Cell('pcmu_bridge.unpaced', 5, 'cpu', legs=8).run(0.2, True, "
            "time.perf_counter(), harness.BENCH_DIR / 'out')\n"
            "print(r['correct'], harness.forbidden_modules(),"
            " 'mediastreamer2_tpu_torch' in sys.modules)\n")
    res = _python(code)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.split()[-3:] == ["True", "[]", "True"]


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "bench_gpu" / "reference").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] in {"torch", "numpy", "math", "bench_gpu",
                                              "__future__"}, (path.name, name)
    res = _python("import sys, bench_gpu.reference.graphs as g\n"
                  "[g.system({'system': p.stem}) for p in"
                  " (g.files.BENCH_DIR / 'reference' / 'systems').glob('*.py')]\n"
                  "print(sorted({m.split('.')[0] for m in sys.modules} & "
                  "{'mediastreamer2_tpu_torch', 'mediastreamer2_tpu', 'jax'}))")
    assert res.returncode == 0 and res.stdout.strip() == "[]", res.stderr


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")


def test_without_a_card_a_run_fails_and_prints_nothing(no_card):
    res = subprocess.run([sys.executable, "-m", "bench_gpu.run", "--workload",
                          "flagship48k.unpaced", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""


def test_without_the_program_a_run_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench_gpu", tmp_path / "bench_gpu",
                    ignore=shutil.ignore_patterns("out", "__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "bench_gpu.run", "--workload",
                          "flagship48k.unpaced", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == ""
