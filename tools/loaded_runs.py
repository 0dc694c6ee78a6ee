#!/usr/bin/env python3
"""Run one pytest node id in several copies at once, round after round, and
count the rounds' passes: a test that passes alone but fails when the host
is loaded (paced tickers that slip) shows here.

    python3 tools/loaded_runs.py TEST_ID [--copies 6] [--rounds 20] [--timeout 600]

Each copy is ``python -m pytest -q -p no:cacheprovider TEST_ID`` from the
repo root with ``JAX_PLATFORMS=cpu``; a round starts its copies together
and waits for all of them. Prints one line a round (the copies' exit
codes) and, last, the passes of all the runs; exits 1 if any run failed.
The output of a failed run goes to stderr.
"""
import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("test_id", help="a pytest node id, e.g. tests/test_x.py::test_y")
    ap.add_argument("--copies", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds a run may take")
    args = ap.parse_args(argv)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cmd = [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", args.test_id]
    passed = runs = 0
    for r in range(args.rounds):
        procs = [subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for _ in range(args.copies)]
        rcs = []
        for p in procs:
            try:
                out, _ = p.communicate(timeout=args.timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            rcs.append(p.returncode)
            if p.returncode != 0:
                print(out, file=sys.stderr)
        runs += len(rcs)
        passed += rcs.count(0)
        print(f"round {r + 1}: exit codes {rcs}", flush=True)
    print(f"{args.test_id}: {passed} of {runs} runs passed ({args.copies} at once, "
          f"{args.rounds} rounds)", flush=True)
    return 0 if passed == runs else 1


if __name__ == "__main__":
    sys.exit(main())
