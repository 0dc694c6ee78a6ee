#!/usr/bin/env python3
"""Which operations of the flagship's tick give a leg a different result
when the batch around it changes size: the graph at ``--legs`` legs
against one shard of it (``--shard`` legs at ``--rank``, the sharded
build of ``parallel/sharding.sharded_step``), on the same inputs, every
PyTorch operation of each tick recorded by a dispatch mode and the
shard's rows of each result compared bit for bit with the whole batch's.
Prints, per tick, the operations whose rows differ (name, shapes, how many
elements) and the first of them; the hand kernels (ctypes) are not
PyTorch operations, their outputs show in the next operation that reads
them. With ``--matmul`` it also checks each product shape of the tick
alone: ``x[rows] @ w`` against ``(x @ w)[rows]``.

    python3 tools/batch_invariance.py [--legs 4096] [--shard 1024] [--rank 1] [--ticks 3]

Runs on the card by default (``--device cpu`` on the CPU); the flagship's
groups of four are aligned to the shard, so no collective runs and no
process group is made.
"""
import argparse
import os
import sys

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


class Recorder(TorchDispatchMode):
    """Every operation's name and its first tensor output, in order."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        first = out[0] if isinstance(out, (tuple, list)) and out else out
        if isinstance(first, torch.Tensor):
            self.ops.append((str(func.overloadpacket.__name__), first.detach().clone()))
        return out


def _bits(t):
    dt = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()]
    return t.contiguous().view(dt)


def compare(full_ops, shard_ops, legs, off, b):
    """[(name, full shape, differing elements)] of the operations whose
    shard rows differ; operations without a leg axis are skipped."""
    bad = []
    for (name, a), (name2, s) in zip(full_ops, shard_ops):
        if name != name2:
            raise AssertionError(f"the two runs' operations diverge: {name} vs {name2}")
        if a.dim() == 0 or a.shape[0] != legs or s.shape[0] != b or a.shape[1:] != s.shape[1:]:
            continue
        n = int((_bits(a[off:off + b]) != _bits(s)).sum())
        if n:
            bad.append((name, tuple(a.shape), n))
    return bad


def product_shapes():
    """[(K, N)] of the matrix products in the flagship's tick: x [legs, K]
    @ w [K, N] (the AEC's DFTs, the resampler)."""
    from mediastreamer2_tpu_torch.ops.resample import resample_matrix
    _, H, _ = resample_matrix(48000, 16000)
    return [(960, 481), (481, 480), (480, 481), (481, 481), (480, 241), (241, 480),
            (H + 480, 160)]


def products(dev, legs, off, b):
    """Each product shape of the flagship's tick alone: [(K, N, rows
    differ)] for x [legs, K] @ w [K, N]."""
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for K, N in product_shapes():
        x = torch.randn((legs, K), generator=g, device=dev)
        w = torch.randn((K, N), generator=g, device=dev)
        full = (x @ w)[off:off + b]
        part = x[off:off + b] @ w
        out.append((K, N, int((_bits(full) != _bits(part)).any(dim=1).sum())))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--legs", type=int, default=4096)
    ap.add_argument("--shard", type=int, default=1024)
    ap.add_argument("--rank", type=int, default=1)
    ap.add_argument("--ticks", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--matmul", action="store_true")
    args = ap.parse_args()
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("batch_invariance: no CUDA device")
    from mediastreamer2_tpu_torch import Factory
    from mediastreamer2_tpu_torch.core.graph import clone_tree
    from mediastreamer2_tpu_torch.models.flagship import build_flagship, echo_coupled_inputs
    from mediastreamer2_tpu_torch.parallel.sharding import LegMesh, shard_tree, sharded_step
    legs, b = args.legs, args.shard
    world = legs // b
    off = args.rank * b
    card = "cpu"
    if dev.type == "cuda":
        import chip_smoke
        card = chip_smoke.card_line()
    print(f"CUBLAS_WORKSPACE_CONFIG={os.environ.get('CUBLAS_WORKSPACE_CONFIG')!r} [{card}]",
          flush=True)
    if args.matmul:
        for K, N, n in products(dev, legs, off, b):
            print(f"product [{legs}, {K}] @ [{K}, {N}]: rows [{off}, {off + b}) alone differ "
                  f"on {n} of {b} rows [{card}]", flush=True)
    mic, far = echo_coupled_inputs(legs, args.ticks, seed=15)
    cg, params = build_flagship(Factory(), legs, dev)
    run = sharded_step(cg, LegMesh(rank=args.rank, world=world, device=dev))
    st_full, st_shard = cg.init_state(dev), run.init_state()
    pr_shard = shard_tree(params, run.mesh, legs, run.param_axes)
    step = run.graph.step                   # the local graph, the trees cut outside
    for t in range(-1, args.ticks):         # tick -1 fills the bases' caches, on copies
        cols = slice(max(t, 0) * 480, (max(t, 0) + 1) * 480)
        ext = {"mic": torch.from_numpy(np.ascontiguousarray(mic[:, cols])).to(dev),
               "spk_ref": torch.from_numpy(np.ascontiguousarray(far[:, cols])).to(dev)}
        ext_shard = shard_tree(ext, run.mesh, legs, run.ext_axes)
        if t < 0:
            cg.step(clone_tree(st_full), params, ext)
            step(clone_tree(st_shard), pr_shard, ext_shard)
            continue
        rec_full, rec_shard = Recorder(), Recorder()
        with rec_full:
            st_full, out_full, _ = cg.step(st_full, params, ext)
        with rec_shard:
            st_shard, out_shard, _ = step(st_shard, pr_shard, ext_shard)
        bad = compare(rec_full.ops, rec_shard.ops, legs, off, b)
        rows = int((_bits(out_full["out"][off:off + b]) != _bits(out_shard["out"]))
                   .any(dim=1).sum())
        print(f"tick {t}: {len(rec_full.ops)} operations, {len(bad)} with differing rows, "
              f"output rows differing {rows} of {b}; first: {bad[:1]} [{card}]", flush=True)
        for name, shape, n in bad[:12]:
            print(f"  {name} {shape}: {n} elements differ", flush=True)
        # carry the whole batch's state into the shard, so that each tick
        # shows what that tick's operations do
        st_shard = shard_tree(st_full, run.mesh, legs, run.state_axes)


if __name__ == "__main__":
    main()
