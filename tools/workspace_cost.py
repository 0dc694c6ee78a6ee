#!/usr/bin/env python3
"""What running with no cuBLAS workspace costs the flagship on the card.

A shard process runs with ``CUBLAS_WORKSPACE_CONFIG=:0:0`` (no workspace:
no split-K product, so a product's bits do not follow the batch;
``parallel/sharding.py``). This script runs the unsharded flagship at
``--legs`` legs for ``--ticks`` ticks, and each matrix product of its tick
alone (``tools/batch_invariance.product_shapes``) at ``--legs`` rows and
at a shard's ``--legs // 4``, in fresh processes with the variable unset
(cuBLAS's default) and set to ``:0:0``, ``--pairs`` times in the order
default, none, none, default, ... Each process prints one line: the
flagship's host ms a tick (ticks 1.., ending in a synchronize) and each
product's device ms (CUDA events, the median of 100 calls). Then the
medians of each setting and the ratio none / default.

    python3 tools/workspace_cost.py [--legs 4096] [--ticks 100] [--pairs 3]

Needs one CUDA card. The inputs are the echo-coupled fixture's
distribution drawn on the card (a white far end, near-end noise, half
the far end 400 samples late), from a seed.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SETTINGS = {"default": None, "none": ":0:0"}
REPS = 100


def product_ms(dev, rows, K, N):
    """Device ms of x [rows, K] @ w [K, N], the median of ``REPS`` calls."""
    g = torch.Generator(device=dev).manual_seed(K * N)
    x = torch.randn((rows, K), generator=g, device=dev)
    w = torch.randn((K, N), generator=g, device=dev)
    for _ in range(10):
        x @ w
    times = []
    for _ in range(REPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        x @ w
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def child(legs, ticks):
    """One process's measurements, as one JSON line."""
    from batch_invariance import product_shapes
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.models.flagship import build_flagship
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(15)
    S = 480
    far = 0.2 * torch.randn((legs, ticks * S), generator=g, device=dev)
    mic = 0.05 * torch.randn((legs, ticks * S), generator=g, device=dev) \
        + 0.5 * torch.roll(far, 400, dims=1)
    cg, params = build_flagship(Factory(), legs, dev)
    state = cg.init_state(dev)
    for t in range(ticks):
        if t == 1:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        state, _, _ = cg.step(state, params, {"mic": mic[:, t * S:(t + 1) * S].contiguous(),
                                              "spk_ref": far[:, t * S:(t + 1) * S].contiguous()})
    torch.cuda.synchronize(dev)
    ms_tick = 1e3 * (time.perf_counter() - t0) / (ticks - 1)
    products = {f"{rows}x{K}@{N}": product_ms(dev, rows, K, N)
                for rows in (legs, legs // 4) for K, N in product_shapes()}
    print(json.dumps({"setting": os.environ.get("CUBLAS_WORKSPACE_CONFIG"),
                      "ms_tick": ms_tick, "products_ms": products}), flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--legs", type=int, default=4096)
    ap.add_argument("--ticks", type=int, default=100)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("workspace_cost: no CUDA device")
    if args.child:
        return child(args.legs, args.ticks)
    import chip_smoke
    from mediastreamer2_tpu_torch.ops import kernels
    card = chip_smoke.card_line()
    kernels.build()
    order = [n for i in range(args.pairs)
             for n in (("default", "none") if i % 2 == 0 else ("none", "default"))]
    got = {n: [] for n in SETTINGS}
    for name in order:
        env = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
        if SETTINGS[name] is not None:
            env["CUBLAS_WORKSPACE_CONFIG"] = SETTINGS[name]
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--child",
                              "--legs", str(args.legs), "--ticks", str(args.ticks)],
                             env=env, capture_output=True, text=True, check=True)
        r = json.loads(res.stdout.strip().splitlines()[-1])
        got[name].append(r)
        print(f"workspace {name}: {args.legs} legs x {args.ticks} ticks {r['ms_tick']:.3f} "
              f"ms/tick (host clock); products (device ms) "
              + ", ".join(f"{k} {v:.4f}" for k, v in r["products_ms"].items())
              + f" [{card}]", flush=True)
    med = {n: {"ms_tick": statistics.median(r["ms_tick"] for r in rs),
               "products_ms": {k: statistics.median(r["products_ms"][k] for r in rs)
                               for k in rs[0]["products_ms"]}} for n, rs in got.items()}
    d, z = med["default"], med["none"]
    print(f"medians over {args.pairs} each: ms/tick default {d['ms_tick']:.3f}, none "
          f"{z['ms_tick']:.3f} (none / default {z['ms_tick'] / d['ms_tick']:.3f}); products "
          f"none / default: " + ", ".join(
              f"{k} {z['products_ms'][k]:.4f} / {d['products_ms'][k]:.4f}"
              for k in d["products_ms"]) + f" [{card}]", flush=True)
    for rows in (args.legs, args.legs // 4):
        pick = lambda m: sum(v for k, v in m["products_ms"].items() if k.startswith(f"{rows}x"))
        print(f"the seven product shapes once each at {rows} rows, device ms: default "
              f"{pick(d):.4f}, none {pick(z):.4f} [{card}]", flush=True)


if __name__ == "__main__":
    main()
