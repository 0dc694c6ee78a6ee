"""Gaussian noise at ``rms``, ``rate`` Hz."""
from bench_gpu.reference import ops


def make(sig, made, legs, R, randn, device):
    return randn(R, legs, ops.tick_samples(int(sig["rate"]))).mul_(float(sig["rms"]))
