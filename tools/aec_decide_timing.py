#!/usr/bin/env python3
"""The echo canceller's ``aec_decide`` kernel on the card at the shapes its
callers run: held to its plain version (``chip_smoke.check_decide``: flags,
counters and e_s equal, the rest within rtol 1e-5) with and without the
suppressor, then timed as chip_smoke.py phase 2 times a
kernel (the stream spins, then one event pair around 50 launches, over
input sets that spill the L2) beside its bound and its plain version (the
PyTorch operations it replaced). One JSON line a shape, with the card's
name and power limit, and the kernels' registers from nvcc's report.

    python3 tools/aec_decide_timing.py

Shapes (B, S): the benchmark's 32,768 and 19,456 flagship legs (480
samples a tick), chip_smoke's 4,096, and the session's 1,024 at 80 and
160 samples. Needs one CUDA card and nvcc.
"""
import json
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from mediastreamer2_tpu_torch.ops import aec, kernels  # noqa: E402

SHAPES = ((32768, 480), (19456, 480), (4096, 480), (1024, 160), (1024, 80), (1024, 960),
          (1024, 882))


def main():
    if not torch.cuda.is_available():
        raise SystemExit("aec_decide_timing: no CUDA device")
    card = chip_smoke.card_line()
    _, log = kernels.build()
    for g, long_rows in ((8, 0), (16, 0), (32, 0), (32, 1)):
        for vec in (1, 0):
            u = chip_smoke.ptxas_usage(log, f"aec_decide_kernelILi{g}ELb{vec}ELb{long_rows}E")
            print(json.dumps({"kernel": f"aec_decide<{g}, {bool(vec)}, {bool(long_rows)}>", **u}),
                  flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(26)
    for B, S in SHAPES:
        err = 0.0
        for suppress in (True, False):
            err = max(err, chip_smoke.check_decide(
                kernels, f"aec_decide [{B}, {S}]", chip_smoke.decide_args(g, B, S),
                suppress)[0])
        r = chip_smoke._timed({"max_abs_err": err}, chip_smoke.aec_decide_cost(B, S),
                              lambda: chip_smoke.decide_args(g, B, S),
                              lambda *a: kernels.aec_decide(*a, aec.DECIDE),
                              lambda *a: kernels.aec_decide_reference(*a, aec.DECIDE))
        r.update(B=B, S=S, share=r["bound_ms"] / r["ms"], card=card)
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
