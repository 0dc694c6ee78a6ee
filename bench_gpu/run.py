"""Run one cell of the benchmark once:

    python3 -m bench_gpu.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the CUDA devices the cell
asks for. Prints the compared numbers on standard error and, as the last
line of standard output, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1`` a
``breakdown``, and last ``compared``. Exits with another code than 0, and
prints no result, without the devices or when a forbidden module loaded.
Caches and traces go to ``bench_gpu/out/`` in the checkout.
"""
import time

T_PROCESS0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

OUT = Path(__file__).resolve().parent / "out"


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m bench_gpu.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(OUT / "cache" / sub)
    from bench_gpu import harness
    return harness.main(args, T_PROCESS0)


if __name__ == "__main__":
    sys.exit(main())
