"""Files that the benchmark finds by a name in ``BENCHMARK.json`` or in a
configuration or traffic file: a configuration's system and its reference,
a signal kind, a per-layer metric's reader."""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent


def load_module(path: Path):
    rel = path.resolve().relative_to(BENCH_DIR).with_suffix("").as_posix()
    spec = importlib.util.spec_from_file_location("bench_gpu_" + re.sub(r"\W", "_", rel), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def by_name(folder: str, name: str, what: str):
    """The module ``bench_gpu/<folder>/<name>.py``; a missing file is an
    error that says which ``what`` was asked for."""
    path = BENCH_DIR / folder / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"unknown {what} {name!r}: no file bench_gpu/{folder}/{name}.py")
    return load_module(path)
