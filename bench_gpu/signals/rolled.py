"""One tick of noise at ``rms``, tick t rotated by ``step * t`` samples
(the e2e bench's mic, ``models/e2e_bench.py`` at 19e7661)."""
import torch

from bench_gpu.reference import ops


def make(sig, made, legs, R, randn, device):
    base = randn(legs, ops.tick_samples(int(sig["rate"]))).mul_(float(sig["rms"]))
    step = int(sig["step"])
    return torch.stack([torch.roll(base, step * t, dims=1) for t in range(R)])
